"""The port's logical sharding against the JAX package's, with no world:
the Spec trees' pspec entries leaf for leaf for every registered arch and
model-axis degree (parameters, caches with and without the seq-sharded
timeline, the train state under ZeRO-1), the resolution of logical entries
and the divisibility drop on meshes of the reference's axis names (JAX's
``AbstractMesh``, which allocates nothing, stands in for both packages'
meshes), the elastic re-mesh plan, the port's placements and the rank
slices.  Full configs are Spec trees only: nothing is allocated.  Every
check is exact."""
import dataclasses

import pytest
import torch

from jax.sharding import AbstractMesh

from repro import configs as jconfigs
from repro import train as jtrain
from repro.distributed import elastic as jelastic
from repro.distributed import sharding as jsharding
from repro.launch import mesh as jmesh
from repro.models import get_model as jax_get_model
from repro.models import params as jparams
from repro_torch import configs as tconfigs
from repro_torch.distributed import elastic as telastic
from repro_torch.distributed import sharding as tsharding
from repro_torch.launch import mesh as tmesh
from repro_torch.models import get_model
from repro_torch.models import params as tparams
from repro_torch.train.step import state_spec

PARS = (1, 2, 4, 8, 16)


def _archs():
    tconfigs.get_config("qwen1.5-4b")  # fill the registry
    from repro_torch.configs.base import _REGISTRY

    return sorted(_REGISTRY)


def _leaves(t, j, path=""):
    """Pairs of (path, port Spec, reference Spec) of two Spec trees whose
    keys must match."""
    if isinstance(t, dict):
        assert isinstance(j, dict) and set(t) == set(j), path
        for k in sorted(t):
            yield from _leaves(t[k], j[k], f"{path}/{k}")
    else:
        yield path, t, j


def assert_same_specs(t, j):
    n = 0
    for path, a, b in _leaves(t, j):
        assert (a.shape, a.init, a.scale, a.dtype) == (b.shape, b.init, b.scale, b.dtype), path
        assert tuple(a.pspec) == tuple(b.pspec), (path, a.pspec, b.pspec)
        n += 1
    assert n > 0


def _cfgs(arch, **over):
    return (dataclasses.replace(tconfigs.get_config(arch), **over),
            dataclasses.replace(jconfigs.get_config(arch), **over))


@pytest.mark.parametrize("arch", _archs())
@pytest.mark.parametrize("par", PARS)
def test_param_spec_pspecs_equal_reference(arch, par):
    for ep in (False, True):
        tcfg, jcfg = _cfgs(arch, ep_shard_map=ep)
        assert_same_specs(get_model(tcfg).param_spec(tcfg, par),
                          jax_get_model(jcfg).param_spec(jcfg, par))


@pytest.mark.parametrize("arch", _archs())
@pytest.mark.parametrize("par", PARS)
def test_cache_spec_pspecs_equal_reference(arch, par):
    """With and without the seq-sharded timeline, at a length every
    degree divides and at one none above 1 does."""
    for seq_shard in (False, True):
        tcfg, jcfg = _cfgs(arch, seq_shard_cache=seq_shard)
        for max_seq in (4096, 1001):
            assert_same_specs(get_model(tcfg).cache_spec(tcfg, 8, max_seq, par),
                              jax_get_model(jcfg).cache_spec(jcfg, 8, max_seq, par))


@pytest.mark.parametrize("arch", _archs())
@pytest.mark.parametrize("data_par", (1, 2, 4))
def test_state_spec_zero1_equal_reference(arch, data_par):
    tcfg, jcfg = _cfgs(arch, zero1=True)
    for par in PARS:
        t = state_spec(tcfg, get_model(tcfg).param_spec(tcfg, par), data_par)
        j = jtrain.state_spec(jcfg, jax_get_model(jcfg).param_spec(jcfg, par), data_par)
        assert_same_specs(t, j)


def test_params_pspecs_and_n_params():
    cfg, jcfg = _cfgs("kimi-k2-1t-a32b")
    t, j = get_model(cfg).param_spec(cfg, 8), jax_get_model(jcfg).param_spec(jcfg, 8)
    tp, jp = tparams.pspecs(t), jparams.pspecs(j)
    for path, a, b in _leaves(tp, jp):
        assert a == tuple(b), path
    assert tparams.n_params(t) == jparams.n_params(j)


MESHES = [((2, 4), ("data", "model")), ((16, 16), ("data", "model")),
          ((2, 16, 16), ("pod", "data", "model")), ((1, 1, 1), ("pod", "data", "model")),
          ((8,), ("data",)), ((4,), ("model",)), ((2, 3), ("pod", "data"))]
ENTRIES = [("batch", None), ("batch", "model", None), ("model", None, None),
           (None, "model"), ("batch", None, None, "model"), (("batch", "model"), None),
           ("data", "pod"), ("model",), (None,), ("nope", "batch")]
SHAPES = [(8, 48, 3, 128), (1, 7, 3, 5), (32, 16, 16, 16), (512, 56, 2, 6)]


@pytest.mark.parametrize("shape,axes", MESHES, ids=[str(m[0]) for m in MESHES])
def test_resolve_and_divisibility_drop_equal_reference(shape, axes):
    mesh = AbstractMesh(shape, axes)
    for entries in ENTRIES:
        for e in entries:
            assert tsharding._resolve(e, mesh) == jsharding._resolve(e, mesh), e
        for dims in SHAPES:
            got = tsharding.named_sharding(mesh, entries, dims[:len(entries)])
            want = tuple(jsharding.named_sharding(mesh, entries, dims[:len(entries)]).spec)
            assert got == want, (entries, dims)
        assert tsharding.named_sharding(mesh, entries) == \
            tuple(jsharding.named_sharding(mesh, entries).spec)
    assert tmesh.model_par(mesh) == jmesh.model_par(mesh)
    assert tmesh.data_par(mesh) == jmesh.data_par(mesh)
    assert tsharding.batch_axes(mesh) == jsharding.batch_axes(mesh)


def test_multi_axis_batch_resolution():
    """The reference's test: "batch" on a pod mesh is ("pod", "data")."""
    mesh = AbstractMesh((1, 1, 1), ("pod", "data", "model"))
    assert tsharding.named_sharding(mesh, ("batch", None), (8, 2))[0] == ("pod", "data")


def test_spec_and_entry_tree_shardings_equal_reference():
    mesh = AbstractMesh((2, 2, 4), ("pod", "data", "model"))
    tcfg, jcfg = _cfgs("internlm2-20b", seq_shard_cache=True)
    t = tsharding.spec_tree_shardings(get_model(tcfg).cache_spec(tcfg, 8, 64, 4), mesh)
    j = jsharding.spec_tree_shardings(jax_get_model(jcfg).cache_spec(jcfg, 8, 64, 4), mesh)
    for k in ("k", "v", "pos"):
        assert t[k] == tuple(j[k].spec), k
    entries = {"tokens": ("batch", None), "frames": ("batch", None, None)}
    shapes = {"tokens": torch.empty(6, 3, device="meta"),
              "frames": torch.empty(8, 2, 2, device="meta")}
    got = tsharding.entry_tree_shardings(entries, mesh, shapes)
    jshapes = {k: type("A", (), {"shape": tuple(v.shape)})() for k, v in shapes.items()}
    want = jsharding.entry_tree_shardings(entries, mesh, jshapes)
    assert {k: got[k] for k in got} == {k: tuple(want[k].spec) for k in want}


def test_shard_is_identity_and_maybe_axis():
    tsharding.set_current_mesh(None)
    x = torch.ones(4, 4)
    assert tsharding.shard(x, "batch", None) is x
    assert tsharding.resolve_pspec(("batch",)) == ()
    for dim in (1, 7, 16, 56, 128):
        for par in (0, 1, 2, 16):
            assert tsharding.maybe_axis("model", dim, par) == jsharding.maybe_axis("model", dim, par)


def test_plan_remesh_equals_reference():
    """Every world of 1 to 4096 ranks at the reference property test's
    model degrees (its hypothesis range, swept whole), both layouts."""
    for mp in (1, 2, 4, 8, 16):
        for n in range(1, 4097):
            for pods in (True, False):
                if n < mp:
                    with pytest.raises(ValueError):
                        telastic.plan_remesh(n, model_par=mp, prefer_pods=pods)
                    continue
                got = telastic.plan_remesh(n, model_par=mp, prefer_pods=pods)
                want = jelastic.plan_remesh(n, model_par=mp, prefer_pods=pods)
                assert (got.shape, got.axes, got.n_devices) == \
                    (want.shape, want.axes, want.n_devices)


class _Mesh:
    """A mesh stand-in at a coordinate: what placements and slices read."""

    def __init__(self, shape, axes, coord):
        self.axis_names = tuple(axes)
        self.shape = dict(zip(axes, shape))
        self.coord = dict(zip(axes, coord))

    def size(self, axes):
        n = 1
        for a in axes:
            n *= self.shape[a]
        return n

    index = tmesh.Mesh.index


def test_placements_hold_only_what_the_port_shards():
    """A model rank holds every leaf with a "model" entry sliced, by the
    whole key paths its family names: the reference's tensor parallelism
    of the dense leaves (attention by scheme, the MLPs, the vocabulary),
    the experts, the cache (its kv heads, or its timeline under the
    seq-sharded decode); the router whole under expert parallelism, where
    its pspec has no "model" entry; batch entries stay.  RG-LRU's
    ``gate_a``, held whole, keeps no "model" axis; mamba's ``in_proj``
    (and its m) takes the Parts layout of its x|z columns."""
    mesh = _Mesh((2, 2), ("data", "model"), (1, 0))
    cfg = dataclasses.replace(tconfigs.get_config("arctic-480b"), ep_shard_map=True,
                              seq_shard_cache=True, zero1=True)
    api = get_model(cfg)
    sp, local = tsharding.rank_placements(cfg, state_spec(cfg, api.param_spec(cfg, 2), 2), mesh,
                                          "state")
    pl = sp["params"]
    assert pl["layers"]["experts"]["w_up"] == (None, "model", None, None)
    assert local["params"]["layers"]["experts"]["w_up"].shape[1] == cfg.n_experts // 2
    assert pl["embed"] == ("model", None) and pl["lm_head"] == (None, "model")
    assert pl["layers"]["attn"]["wq"] == (None, None, "model", None)  # heads: 56 and 8 over 2
    assert pl["layers"]["attn"]["wo"] == (None, "model", None, None)
    assert pl["layers"]["dense_mlp"]["w_down"] == (None, "model", None)
    assert pl["layers"]["router"] == (None, None, None) and pl["layers"]["norm1"] == (None, None)
    assert local["params"]["layers"]["attn"]["wk"].shape[2] == cfg.n_kv_heads // 2
    cp, clocal = tsharding.rank_placements(cfg, api.cache_spec(cfg, 8, 64, 2), mesh, "cache")
    assert cp["k"] == (None, "data", "model", None, None) and cp["pos"] == (None, "data", "model")
    assert clocal["k"].shape[1:3] == (4, 32)
    assert "data" in sp["opt"]["m"]["layers"]["experts"]["w_up"]
    assert "model" in sp["opt"]["m"]["layers"]["experts"]["w_up"]
    assert local["opt"]["m"]["layers"]["experts"]["w_up"].shape[1] == cfg.n_experts // 2
    plain = dataclasses.replace(cfg, ep_shard_map=False, seq_shard_cache=False)
    sliced = api.model_sliced(plain, mesh)
    assert "layers/router" in sliced["params"] and "layers/attn/wq" in sliced["params"]
    assert tsharding.rank_placements(plain, api.cache_spec(plain, 8, 64, 2), mesh,
                                     "cache")[0]["k"] == (None, "data", None, "model", None)
    c = tconfigs.get_config("recurrentgemma-2b")
    a = get_model(c)
    path = "units/l0_rec/mix/gate_a"
    assert path not in a.model_sliced(c, mesh)["params"]
    assert path in tsharding.model_paths(a.param_spec(c, 2))
    places = tsharding.rank_placements(c, state_spec(c, a.param_spec(c, 2)), mesh, "state")[0]
    assert places["params"]["units"]["l0_rec"]["mix"]["gate_a"] == (None,) * 4
    c = tconfigs.get_config("falcon-mamba-7b")
    a = get_model(c)
    assert a.model_sliced(c, mesh)["parts"] == {"layers/in_proj": 2}
    places = tsharding.rank_placements(c, state_spec(c, a.param_spec(c, 2)), mesh, "state")[0]
    for tree in (places["params"], places["opt"]["m"]):
        assert tree["layers"]["in_proj"] == (None, None, tsharding.Parts(("model",), 2))


def test_parts_layout_gathers_to_the_reference_leaf():
    """A leaf in the Parts layout (mamba's x|z columns): each rank holds
    its slice of every block, of the contiguous slice's shape, and the
    ranks' slices put back in order give the whole leaf."""
    x = torch.arange(3 * 16).reshape(3, 16)
    entry = tsharding.Parts(("model",), 2)
    for par in (2, 4):
        got = []
        for r in range(par):
            m = _Mesh((par,), ("model",), (r,))
            sl = tsharding.rank_slice(x, (None, entry), m)
            n = 8 // par
            want = torch.cat([x[:, r * n:(r + 1) * n], x[:, 8 + r * n:8 + (r + 1) * n]], dim=1)
            assert torch.equal(sl, want)
            assert tuple(sl.shape) == tsharding.local_shape(x.shape, (None, entry), m)
            got.append(sl)

        class _Gather(_Mesh):
            def all_gather(self, t, axes, dim):
                return torch.cat(got, dim=dim)

        whole = tsharding.gather_leaf(got[0], (None, entry), _Gather((par,), ("model",), (0,)))
        assert torch.equal(whole, x), par


def test_the_current_mesh_is_the_threads_own():
    """A thread that installed no mesh sees none, whatever mesh another
    thread installed, and a thread's ``set_current_mesh(None)`` leaves
    another thread's mesh as it was."""
    import threading

    mesh = _Mesh((1, 2), ("data", "model"), (0, 1))
    seen = {}
    try:
        tsharding.set_current_mesh(mesh)
        t = threading.Thread(target=lambda: seen.__setitem__("new", tsharding.current_mesh()))
        t.start()
        t.join()
        t = threading.Thread(target=lambda: tsharding.set_current_mesh(None))
        t.start()
        t.join()
        seen["own"] = tsharding.current_mesh()
    finally:
        tsharding.set_current_mesh(None)
    assert seen == {"new": None, "own": mesh}


@pytest.mark.parametrize("policy", ["full", "dots"])
def test_remat_recompute_sees_the_forward_mesh(policy):
    """A remat'd layer recomputed in a backward run on another thread (as
    the autograd engine's device thread runs a CUDA step's) sees the mesh
    its forward ran under, and leaves that thread's own mesh as it was."""
    import threading
    import types

    from repro_torch.models import transformer as T

    mesh = _Mesh((1, 2), ("data", "model"), (0, 1))
    seen = []

    def layer(w, x):
        seen.append(tsharding.current_mesh())
        return (x @ w).sin()

    w = torch.randn(4, 4, requires_grad=True)
    x = torch.randn(3, 4)
    try:
        tsharding.set_current_mesh(mesh)
        y = T.remat(layer, types.SimpleNamespace(remat=policy))(w, x)
    finally:
        tsharding.set_current_mesh(None)
    after = {}

    def backward():
        y.sum().backward()
        after["mesh"] = tsharding.current_mesh()

    t = threading.Thread(target=backward)
    t.start()
    t.join()
    assert seen == [mesh, mesh] and after == {"mesh": None}
    w2 = w.detach().requires_grad_()
    (x @ w2).sin().sum().backward()
    assert torch.equal(w.grad, w2.grad)


def test_placements_match_whole_paths():
    """A leaf is sliced over "model" by the whole key path its family
    names: whisper's caches on their head dim (its "hd" scheme), the
    cross keys too; whisper refuses the seq-sharded decode it has no
    layout for; the hybrid family names its attention layers' cache
    timelines and its rec caches' width; and a named path the tree lacks
    raises."""
    mesh = _Mesh((1, 2), ("data", "model"), (0, 1))
    wcfg = tconfigs.get_config("whisper-tiny")
    wapi = get_model(wcfg)
    wcache = wapi.cache_spec(wcfg, 8, 64, 2)
    assert "model" in wcache["k"].pspec
    wp, _ = tsharding.rank_placements(wcfg, wcache, mesh, "cache")
    assert wp["k"][-1] == "model" and wp["xk"][-1] == "model" and wp["pos"] == (None, "data", None)
    with pytest.raises(ValueError, match="seq-sharded"):
        wapi.model_sliced(dataclasses.replace(wcfg, seq_shard_cache=True), mesh)
    rcfg = dataclasses.replace(tconfigs.get_config("recurrentgemma-2b"), seq_shard_cache=True)
    rapi = get_model(rcfg)
    rp, _ = tsharding.rank_placements(rcfg, rapi.cache_spec(rcfg, 8, 4096, 2), mesh, "cache")
    attn = [k for k in rp["units"] if not k.endswith("_rec")]
    assert attn and all(rp["units"][k]["k"][2] == "model" for k in attn)
    assert all(rp["units"][k]["h"] == (None, "data", "model")
               for k in rp["units"] if k.endswith("_rec"))
    with pytest.raises(ValueError, match="no leaf"):
        tsharding.placements({"k": tparams.Spec((4, 8), pspec=(None, "model"))}, mesh,
                             ("layers/k",))


@pytest.mark.parametrize("shape,axes", [((2, 2), ("data", "model")),
                                        ((2, 2, 2), ("pod", "data", "model"))])
def test_rank_slices_tile_the_leaf(shape, axes):
    """The ranks' slices of a leaf (rank_slice, local_shape) are disjoint
    and cover it, in the mesh's index order."""
    import itertools

    x = torch.arange(8 * 6 * 4).reshape(8, 6, 4)
    for sharding in [(("pod", "data") if "pod" in axes else "data", "model", None),
                     (None, None, "model"), ("model", None, None), (None, None, None)]:
        seen = torch.zeros_like(x)
        for coord in itertools.product(*(range(n) for n in shape)):
            m = _Mesh(shape, axes, coord)
            sl = tsharding.rank_slice(x, sharding, m)
            assert tuple(sl.shape) == tsharding.local_shape(x.shape, sharding, m)
            mask = torch.zeros_like(x, dtype=torch.bool)
            idx = []
            for i, r in enumerate(sharding):
                if r is None:
                    idx.append(slice(None))
                    continue
                ax = tsharding.axes_of(r)
                n = x.shape[i] // m.size(ax)
                idx.append(slice(m.index(ax) * n, (m.index(ax) + 1) * n))
            mask[tuple(idx)] = True
            assert torch.equal(sl, x[tuple(idx)])
            seen += mask.long()
        reps = len(list(itertools.product(*(range(n) for n in shape)))) // max(
            1, int(torch.tensor([m.size(tsharding.axes_of(r)) for r in sharding]).prod()))
        assert torch.all(seen == reps), sharding


def test_production_mesh_refuses_other_worlds():
    with pytest.raises(ValueError, match="256"):
        tmesh.make_production_mesh()
    with pytest.raises(ValueError, match="512"):
        tmesh.make_production_mesh(multi_pod=True)
    with pytest.raises(RuntimeError, match="initialised"):
        tmesh.make_mesh((1,), ("data",), "cpu")


def test_mesh_and_elastic_runner_default_to_cuda(monkeypatch):
    """A mesh and an elastic runner compute on cuda unless the CPU is
    asked for, and raise without a card, as every entry point does."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tmesh.make_mesh((1,), ("data",))
    cfg = tconfigs.reduced(tconfigs.get_config("qwen1.5-4b"))
    kw = dict(state_spec_fn=None, step_factory=None, ckpt_dir="unused", model_par=1)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        telastic.ElasticRunner(cfg, get_model(cfg), **kw)
    assert telastic.ElasticRunner(cfg, get_model(cfg), device="cpu", **kw).device.type == "cpu"


def test_backend_choice():
    """gloo on the CPU and for ranks that share one card; NCCL needs a
    card a rank (decided by the count of cards, not by trying)."""
    assert tmesh.backend_for("cpu", 4) == "gloo"
    n = torch.cuda.device_count()
    assert tmesh.backend_for("cuda", n + 1) == "gloo"


@pytest.mark.parametrize("cards,local,world,backend", [
    (8, None, 8, "nccl"),      # one node, a card a rank
    (1, None, 4, "gloo"),      # one node's ranks share its card
    (8, 8, 256, "nccl"),       # torchrun over 32 nodes of 8 cards
    (8, 8, 2, "nccl"),         # an elastic rebuild down to 2 ranks
    (1, 4, 8, "raise"),        # two nodes whose ranks would share cards
    (4, None, 8, "gloo"),      # one node, more ranks than cards
])
def test_backend_is_decided_per_node(monkeypatch, cards, local, world, backend):
    """The backend follows each node's ranks (``LOCAL_WORLD_SIZE`` under
    torchrun) against its cards; a rank's card is its node-local rank."""
    monkeypatch.setattr(torch.cuda, "device_count", lambda: cards)
    if local is None:
        monkeypatch.delenv("LOCAL_WORLD_SIZE", raising=False)
    else:
        monkeypatch.setenv("LOCAL_WORLD_SIZE", str(local))
    if backend == "raise":
        with pytest.raises(ValueError, match="several nodes"):
            tmesh.backend_for("cuda", world)
        return
    assert tmesh.backend_for("cuda", world) == backend
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    picked = []
    monkeypatch.setattr(torch.cuda, "set_device", picked.append)
    monkeypatch.setenv("LOCAL_RANK", "3")
    dev = tmesh.rank_device("cuda", world, 100)
    assert dev.index == (3 if backend == "nccl" else 0) and picked == [dev.index]
