"""Helpers of the tensor-parallel tests, in the parent test process only
(the ranks run ``_mesh_ranks.tp_world`` and import no JAX): the cases --
a reduced config, JAX weights as numpy, a prompt batch, teacher-forced
decode tokens and a train batch, all from seeds -- the JAX package's
single-device references, the port's one-rank gradients, and the
reference's shard shapes of each parameter leaf."""
import dataclasses
import functools

import numpy as np
import torch

import jax
import jax.numpy as jnp
from jax.sharding import AbstractMesh

from _mesh_parity import jax_params, rel_l2
from repro import configs as jconfigs
from repro.distributed import sharding as jsharding
from repro.models import get_model as jax_get_model
from repro.models import moe as jmoe
from repro.models import params as jparams
from repro_torch import configs as tconfigs
from repro_torch.configs import ShapeCell
from repro_torch.data import to_device
from repro_torch.launch.specs import make_batch
from repro_torch.models import get_model
from repro_torch.models import moe as tmoe
from repro_torch.models import params as tparams
from repro_torch.serve import make_generate
from repro_torch.serve.step import prefix_len, zeros_cache
from repro_torch.train.step import loss_and_grads

# Logits against the JAX package's single-device functions at the mesh
# tests' bound (the one-rank port itself parts from them by up to 5e-5 on
# these configs: XLA and torch order float32 sums differently), and
# against the port's one-rank run at 1e-5 of the logits' largest
# magnitude (the ranks' partial sums add in another order); the loss
# against the JAX loss;
# gradients relative L2 a leaf against the port's one-rank gradients.
LOGIT_TOL, ONE_RANK_TOL, LOSS_TOL, GRAD_REL = 1e-4, 1e-5, 1e-5, 1e-4
B, S, STEPS = 4, 8, 3


def make_case(name, arch, capacity_factor=1.25, max_seq=0, grad_rel=GRAD_REL, generate=0,
              **over):
    """A case of ``tp_world``: the reduced ``arch`` with ``over``, both
    packages' configs, from seeds; a cache of ``max_seq`` positions (0:
    the prompt and its decode steps); its gradients held at ``grad_rel``;
    ``generate`` > 0: one-shot generate of that many tokens too."""
    tcfg = dataclasses.replace(tconfigs.reduced(tconfigs.get_config(arch)), **over)
    jcfg = dataclasses.replace(jconfigs.reduced(jconfigs.get_config(arch)), **over)
    jp, np_params = jax_params(jcfg)
    cell = ShapeCell("tp", S, B, "prefill")
    rng = np.random.default_rng(5)
    steps = [rng.integers(0, tcfg.vocab, (B, 1)).astype(np.int32) for _ in range(STEPS)]
    case = {"name": name, "cfg": tcfg, "params": np_params, "batch": make_batch(tcfg, cell, 3),
            "train": make_batch(tcfg, cell, 4), "steps": steps,
            "max_seq": max_seq or prefix_len(tcfg) + S + STEPS,
            "capacity_factor": capacity_factor, "grad_rel": grad_rel, "generate": generate}
    return case, jcfg, jp


def jax_reference(case, jcfg, jp):
    """The JAX package's prefill and teacher-forced decode logits and its
    train loss of ``case``, on one device, at the case's capacity."""
    japi = jax_get_model(jcfg)
    factor, jmoe.CAPACITY_FACTOR = jmoe.CAPACITY_FACTOR, case["capacity_factor"]
    try:
        cache = jparams.materialize(japi.cache_spec(jcfg, B, case["max_seq"], 1),
                                    jax.random.PRNGKey(2), jnp.float32)
        batch = {k: jnp.asarray(v) for k, v in case["batch"].items()}
        lg, cache = jax.jit(lambda p, b, c: japi.prefill(p, b, jcfg, c))(jp, batch, cache)
        out = [np.asarray(lg)]
        decode = jax.jit(lambda p, t, pos, c: japi.decode(p, t, pos, jcfg, c))
        for i, tok in enumerate(case["steps"]):
            lg, cache = decode(jp, jnp.asarray(tok), jnp.int32(prefix_len(jcfg) + S + i), cache)
            out.append(np.asarray(lg))
        train = {k: jnp.asarray(v) for k, v in case["train"].items()}
        loss = float(jax.jit(lambda p, b: japi.forward_train(p, b, jcfg))(jp, train))
    finally:
        jmoe.CAPACITY_FACTOR = factor
    return out, loss


def one_rank(case):
    """The port's one-rank prefill and teacher-forced decode logits and its
    gradients of the case's train batch."""
    cfg = case["cfg"]
    api = get_model(cfg)
    factor, tmoe.CAPACITY_FACTOR = tmoe.CAPACITY_FACTOR, case["capacity_factor"]
    try:
        params = tparams.load_jax_params(case["params"], cfg, "cpu")
        cache = zeros_cache(cfg, api, B, case["max_seq"], device="cpu")
        lg, cache = api.prefill(params, to_device(case["batch"], "cpu"), cfg, cache)
        out = [lg]
        for i, tok in enumerate(case["steps"]):
            lg, cache = api.decode(params, torch.from_numpy(tok), prefix_len(cfg) + S + i, cfg,
                                   cache)
            out.append(lg)
        grads = loss_and_grads(api, cfg, params, to_device(case["train"], "cpu"))[1]
        return [x.numpy() for x in out], grads
    finally:
        tmoe.CAPACITY_FACTOR = factor


@functools.lru_cache(maxsize=None)
def _paths(cfg):
    out = []
    tparams.tree_map_path(lambda p, s: out.append(p), get_model(cfg).param_spec(cfg))
    return out


def reference_shard_shapes(jcfg, shape, axes):
    """Each parameter leaf's shape on one device of the reference's mesh
    ``shape`` over ``axes`` (its resolved sharding, divisibility drop
    included), by key path."""
    mesh = AbstractMesh(shape, axes)
    par = dict(zip(axes, shape)).get("model", 1)
    spec = jax_get_model(jcfg).param_spec(jcfg, par)
    out = {}

    def walk(t, path):
        if isinstance(t, dict):
            for k in t:
                walk(t[k], f"{path}/{k}" if path else k)
        else:
            ns = jsharding.named_sharding(mesh, tuple(t.pspec), tuple(t.shape))
            out[path] = tuple(ns.shard_shape(tuple(t.shape)))

    walk(spec, "")
    return out


def check_case(res, case, want, jloss, one, grads, coords):
    """Hold one case's results of every rank (``res``: coord -> result)
    against the references: ``want`` and ``jloss`` the JAX package's,
    ``one`` and ``grads`` the port's one-rank logits and gradients.
    ``coords`` groups the ranks by their batch coordinates: the model
    ranks of one group hold the same rows."""
    cfg = case["cfg"]
    for group in coords:
        first = res[group[0]]["cases"][case["name"]]
        for c in group[1:]:  # the model ranks agree bit for bit
            other = res[c]["cases"][case["name"]]
            for a, b in zip(first["logits"] + first["hidden"], other["logits"] + other["hidden"]):
                assert torch.equal(a, b), (case["name"], c)
            assert all(torch.equal(a, b) for a, b in zip(first["greedy"], other["greedy"]))
    for i in range(STEPS + 1):
        got = torch.cat([res[g[0]]["cases"][case["name"]]["logits"][i] for g in coords]).numpy()
        err = float(np.max(np.abs(got - want[i])))
        assert err < LOGIT_TOL, (case["name"], i, err)
        err = float(np.max(np.abs(got - one[i])) / max(1.0, np.max(np.abs(one[i]))))
        assert err < ONE_RANK_TOL, (case["name"], i, err)
        tok = torch.cat([res[g[0]]["cases"][case["name"]]["greedy"][i] for g in coords]).numpy()
        assert np.array_equal(tok, want[i][:, -1].argmax(-1)), (case["name"], i)
    assert len(got) == B
    for r in res.values():
        x = r["cases"][case["name"]]
        assert abs(x["loss"] - jloss) < LOSS_TOL, (case["name"], x["loss"], jloss)
        for p, a, b in zip(_paths(cfg), x["grads"], grads):
            assert rel_l2(a, b) < case["grad_rel"], (case["name"], p)
    after = [r["cases"][case["name"]]["after"] for r in res.values()]
    for a in after[1:]:  # every leaf, whole, equal on every rank after AdamW
        assert all(torch.equal(x, y) for x, y in zip(a, after[0])), case["name"]


def check_shapes(res, case, jcfg, shape, axes):
    """Each rank holds every parameter leaf at the reference's shard
    shape, except the leaves its family names whole (whole there)."""
    want = reference_shard_shapes(jcfg, shape, axes)
    cfg = case["cfg"]
    from repro_torch.distributed.sharding import model_paths

    api = get_model(cfg)
    par = dict(zip(axes, shape)).get("model", 1)
    whole = set(model_paths(api.param_spec(cfg, par)))
    for r in res.values():
        mesh_names = r["cases"][case["name"]]["shapes"]
        assert set(mesh_names) == set(want)
        for path, got in mesh_names.items():
            if path in whole and path not in _sliced_names(cfg, shape, axes):
                assert got == tuple(_spec_shape(cfg, path)), path
            else:
                assert got == want[path], (case["name"], path, got, want[path])


class _Stand:
    def __init__(self, shape, axes):
        self.axis_names, self.shape = tuple(axes), dict(zip(axes, shape))
        self.coord = {a: 0 for a in axes}


def _sliced_names(cfg, shape, axes):
    return set(get_model(cfg).model_sliced(cfg, _Stand(shape, axes))["params"])


def _spec_shape(cfg, path):
    t = get_model(cfg).param_spec(cfg)
    for k in path.split("/"):
        t = t[k]
    return t.shape


class Suite:
    """The cases and worlds of one test module: ``cases`` name -> (arch,
    config overrides and ``capacity_factor``), ``meshes`` name -> (shape,
    axes, case names).  Each mesh's world runs all of its cases in turn
    and starts once; every result is cached."""

    def __init__(self, cases: dict, meshes: dict, ties=None):
        self.cases, self.meshes, self.ties = cases, meshes, ties
        self.case = functools.lru_cache(maxsize=None)(self._case)
        self.reference = functools.lru_cache(maxsize=None)(self._reference)
        self.world = functools.lru_cache(maxsize=None)(self._world)
        self.pairs = [(m, n) for m, (_, _, names) in meshes.items() for n in names]
        self.ids = [f"{m}-{n}" for m, n in self.pairs]

    def _case(self, name):
        arch, over = self.cases[name]
        return make_case(name, arch, **over)

    def _reference(self, name):
        c, jcfg, jp = self.case(name)
        return jax_reference(c, jcfg, jp) + one_rank(c)

    def _world(self, mesh):
        import _mesh_ranks as ranks
        from repro_torch.launch.mesh import fresh_store, spawn_world

        shape, axes, names = self.meshes[mesh]
        res = spawn_world(ranks.tp_world, int(np.prod(shape)), "cpu", fresh_store(),
                          (shape, axes, [self.case(n)[0] for n in names], self.ties))
        return {tuple(r["coord"].values()): r for r in res}

    def check(self, mesh, name):
        res = self.world(mesh)
        check_case(res, self.case(name)[0], *self.reference(name), groups(res))

    def check_shapes(self, mesh, name):
        shape, axes, _ = self.meshes[mesh]
        c, jcfg, _ = self.case(name)
        check_shapes(self.world(mesh), c, jcfg, shape, axes)


def groups(res):
    """The ranks grouped by their batch coordinates (model ranks last)."""
    out = {}
    for c in sorted(res):
        out.setdefault(c[:-1], []).append(c)
    return list(out.values())


def check_generate(suite, mesh, name):
    """``make_generate`` on each rank's rows under the mesh (its cache the
    rank's slice, eager, the greedy token across the vocabulary's slices)
    equals one-rank generate of the whole batch."""
    c = suite.case(name)[0]
    cfg = c["cfg"]
    params = tparams.load_jax_params(c["params"], cfg, "cpu")
    want = make_generate(cfg, get_model(cfg))(params, to_device(c["batch"], "cpu"), c["generate"])
    res = suite.world(mesh)
    got = {}
    for coord, r in res.items():
        got.setdefault(coord[:-1], []).append(r["cases"][name]["generate"])
    rows = []
    for key in sorted(got):
        assert all(torch.equal(g, got[key][0]) for g in got[key])  # the model ranks agree
        rows.append(got[key][0])
    assert torch.equal(torch.cat(rows), want)
