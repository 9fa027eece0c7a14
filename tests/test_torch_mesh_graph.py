"""The mesh steps as CUDA graphs (``serve/graphs.Segments``), held on the
CPU: one gloo world of 2 CPU ranks (``tests/_mesh_graph_ranks.py``, no
JAX), reduced configs in float32.

- The host-read audit: no op of the second step reads the host, for the
  data-parallel train step with ZeRO-1 off and on, the tensor-parallel
  one under the heads scheme and under the qheads scheme with a GQA group
  straddling the ranks (remat "dots" each), and one-shot generate under
  tensor parallelism, expert parallelism and the seq-sharded cache.
- ``graph=True`` against ``graph=False`` under a replay emulation: three
  train steps on (data 2) and on (model 2), bitwise, the state updated in
  place, the mesh's collectives counted the same each step; one-shot
  generate on (model 2), plain and seq-sharded, its tokens bitwise and a
  replayed call's collectives an eager call's.
- The segmented recording with graphs that record nothing: stretches,
  nodes, one pool, no collective issued while recording, every node
  issued and counted at each replay.
- The train step's key separates ranks at two coordinates of one mesh.
- ``_write_owned`` and ``_kv_for`` bitwise the versions that read the host.
- The HeteroTrainer's graphs of one scope share one pool and one set of
  gradient buffers over every share size; two scopes do not.
- Against the JAX package: the graphed tensor-parallel generate's tokens
  equal the JAX ``make_generate``'s on the same weights.
"""
import contextlib
import dataclasses

import numpy as np
import pytest
import torch

import _mesh_graph_ranks as ranks
from repro_torch.configs import get_config, reduced
from repro_torch.distributed import sharding as S
from repro_torch.launch.mesh import AbstractMesh, spawn_world
from repro_torch.models import attention as A
from repro_torch.serve import graphs
from repro_torch.train import step as tstep


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """Rank 0's and rank 1's results of every case, one world for all."""
    return spawn_world(ranks.world, 2, "cpu", tmp_path_factory.mktemp("mesh_graph") / "store")


AUDITED = list(ranks.TRAIN) + list(ranks.GENERATE)


@pytest.mark.parametrize("name", AUDITED)
def test_mesh_step_reads_no_host(world, name):
    """No op of a mesh step's second call reads the host, on either rank."""
    for r in world:
        assert r[f"audit/{name}"] is None, r[f"audit/{name}"]


@pytest.mark.parametrize("name", ["dp", "dp-zero1", "tp-heads"])
def test_graphed_mesh_train_step_equals_eager(world, name):
    """Three steps graphed (an eager step, the capture, two replays) and
    eager: bitwise, in place, step 3, one capture and two replays, and the
    same collectives, in count and bytes, every step."""
    for r in world:
        x = r[f"replay/{name}"]
        assert x["losses_bitwise"] and x["leaves_bitwise"], name
        assert x["in_place"] and x["step"] == 3
        assert x["counters"] == (1, 2)
        graphed, eager = x["stats"]
        assert graphed == eager
        assert all(s["all_reduce"][0] > 0 for s in eager)


@pytest.mark.parametrize("name", ["tp-generate", "seq-generate"])
def test_graphed_mesh_generate_equals_eager(world, name):
    for r in world:
        x = r[f"replay/{name}"]
        assert x["tokens_bitwise"] and x["shape"] == (ranks.BATCH, ranks.GEN)
        assert x["replays"] == 4  # prefill and chain, two calls
        graphed, eager = x["stats"]
        assert graphed == eager and eager["all_reduce"][0] > 0


def test_segmented_recording(world):
    """Four stretches split at three collectives, every capture on one pool
    in the relaxed mode; recording issues nothing and counts nothing; each
    replay runs graph, node, graph, ... and counts the nodes."""
    for rank, r in enumerate(world):
        s = r["segments"]
        assert (s["stretches"], s["collectives"]) == (4, 3)
        assert all(s["pools"]) and set(s["modes"]) == {"relaxed"}
        cap = s["captured"]
        assert torch.equal(cap["x"], torch.full((3,), float(rank + 1)))
        assert cap["stats"] == {"all_reduce": (0, 0), "all_gather": (0, 0)}
        assert cap["open"] == {}
        assert cap["log"] == ["begin", "end", "begin", "end", "begin", "end", "begin", "end"]
        first = s["first"]
        assert first["log"] == ["replay"] * 4 and first["kinds"] == ["all_reduce", "all_gather",
                                                                     "all_reduce"]
        # 1 + 2 summed; the gather saw the sum on both ranks; the max of equals.
        assert torch.equal(first["x"], torch.full((3,), 3.0))
        assert all(torch.equal(p, torch.full((3,), 3.0)) for p in first["parts"])
        assert first["stats"] == {"all_reduce": (2, 24), "all_gather": (1, 12)}
        assert torch.equal(s["second_x"], torch.full((3,), 6.0))
        assert s["second_stats"] == first["stats"]


def test_graph_key_separates_mesh_coordinates():
    """Two ranks of one mesh shape at different coordinates key apart; one
    coordinate keys alike whatever object holds it; no mesh is a third."""
    cfg = reduced(get_config("qwen1.5-4b"))
    inputs = {"tokens": torch.zeros((2, 8), dtype=torch.int32)}
    consts = ({"w": torch.zeros(3)},)

    def key(mesh):
        return tstep.graph_key(cfg, inputs, consts, mesh)

    r0, r1 = (AbstractMesh((2,), ("model",), coord=(c,)) for c in (0, 1))
    assert key(r0) != key(r1)
    assert key(r0) == key(AbstractMesh((2,), ("model",), coord=(0,)))
    assert key(AbstractMesh((2, 1), ("data", "model"), coord=(1, 0))) != key(
        AbstractMesh((1, 2), ("data", "model"), coord=(0, 1)))
    assert key(None) != key(r0)


def _write_owned_host(cache, slot, k, v, positions, mesh):
    """The seq-sharded owner's write as it was: ``nonzero`` over the owned
    rows, a host read."""
    s_loc = cache["k"].shape[1]
    r = mesh.coord["model"]
    bi, ji = (torch.div(slot, s_loc, rounding_mode="floor") == r).nonzero(as_tuple=True)
    local = slot[bi, ji] - r * s_loc
    for name, new in (("k", k), ("v", v), ("pos", positions)):
        cache[name].index_put_((bi, local), new[bi, ji].to(cache[name].dtype))


def _cache(rng, b, s_loc, kv, hd):
    return {"k": torch.from_numpy(rng.standard_normal((b, s_loc, kv, hd))).to(torch.bfloat16),
            "v": torch.from_numpy(rng.standard_normal((b, s_loc, kv, hd))).to(torch.bfloat16),
            "pos": torch.from_numpy(rng.integers(-1, 50, (b, s_loc)).astype(np.int32))}


@pytest.mark.parametrize("case", ["prefill", "prefill-window", "decode", "decode-one-owner"])
@pytest.mark.parametrize("rank", [0, 1])
def test_write_owned_matches_host_read_version(case, rank):
    """Every leaf of the cache after the new owner's write equals, bitwise,
    the ``nonzero`` version's, on seeded caches and rows: a whole prompt
    over both ranks' slots, a rolling window's trailing rows, decode rows
    at random positions, and decode rows all owned by rank 0."""
    rng = np.random.default_rng(11 + rank)
    b, s_loc, kv, hd, par = 3, 8, 2, 4, 2
    cs = s_loc * par
    if case == "prefill":
        pos = np.tile(np.arange(12), (b, 1))
        slot = pos
    elif case == "prefill-window":
        pos = np.tile(np.arange(20), (b, 1))[:, -cs:]
        slot = pos % cs
    elif case == "decode":
        pos = rng.integers(0, cs, (b, 1))
        slot = pos
    else:
        pos = rng.integers(0, s_loc, (b, 1))
        slot = pos
    sq = pos.shape[1]
    k = torch.from_numpy(rng.standard_normal((b, sq, kv, hd)).astype(np.float32))
    v = torch.from_numpy(rng.standard_normal((b, sq, kv, hd)).astype(np.float32))
    positions = torch.from_numpy(pos.astype(np.int32))
    slot = torch.from_numpy(slot).long()
    mesh = AbstractMesh((par,), ("model",), coord=(rank,))
    base = _cache(rng, b, s_loc, kv, hd)
    want = {n: t.clone() for n, t in base.items()}
    got = {n: t.clone() for n, t in base.items()}
    _write_owned_host(want, slot, k, v, positions, mesh)
    A._write_owned(got, slot, k, v, positions, mesh)
    for n in want:
        assert torch.equal(got[n], want[n]), n
    changed = any(not torch.equal(want[n], base[n]) for n in want)
    assert changed == bool(((slot // s_loc) == rank).any())


def _kv_for_host(q, k, v, cfg):
    """``_kv_for`` as it was: its head index made from host data on every
    call."""
    if q.shape[2] == cfg.n_heads or k.shape[2] != cfg.n_kv_heads:
        return k, v
    mesh = S.model_mesh()
    sel = A.kv_heads(q.shape[2], cfg, mesh)
    k, v = S.copy_to(k, mesh, S.MODEL), S.copy_to(v, mesh, S.MODEL)
    if isinstance(sel, tuple):
        return k.narrow(2, *sel), v.narrow(2, *sel)
    idx = torch.tensor(sel, device=k.device)
    return k.index_select(2, idx), v.index_select(2, idx)


@pytest.mark.parametrize("heads", [(6, 3), (8, 2), (4, 4), (10, 1)])
@pytest.mark.parametrize("rank", [0, 1])
def test_kv_for_matches_host_read_version(heads, rank):
    """The rank's k and v under the qheads scheme, bitwise the version that
    made its head index per call: straddling groups (6 over 3), whole
    groups (8 over 2), one kv head a q head (4 over 4), MQA (10 over 1)."""
    h, kv = heads
    cfg = dataclasses.replace(reduced(get_config("internlm2-20b")), n_heads=h, n_kv_heads=kv)
    rng = np.random.default_rng(h * 10 + kv + rank)
    q = torch.from_numpy(rng.standard_normal((2, 5, h // 2, 4)).astype(np.float32))
    k, v = (torch.from_numpy(rng.standard_normal((2, 5, kv, 4)).astype(np.float32))
            for _ in range(2))
    S.set_current_mesh(AbstractMesh((2,), ("model",), coord=(rank,)))
    try:
        with torch.no_grad():
            want = _kv_for_host(q, k, v, cfg)
            got = A._kv_for(q, k, v, cfg)
            again = A._kv_for(q, k, v, cfg)
    finally:
        S.set_current_mesh(None)
    for g, a, w in zip(got, again, want):
        assert torch.equal(g, w) and torch.equal(a, w)


class _NoDevice:
    """``torch.cuda.device`` on the CPU: a context that sets nothing."""

    def __init__(self, device) -> None:
        pass

    def __enter__(self):
        return self

    def __exit__(self, *exc) -> bool:
        return False


@contextlib.contextmanager
def fake_card(monkeypatch):
    """A GraphCache that records on the CPU through the real
    :meth:`GraphCache._record` and :class:`graphs.Segments`, its CUDA calls
    stubbed and its graphs :class:`_mesh_graph_ranks.FakeGraph` (the
    capture runs the body; a replay runs nothing)."""
    handles = []

    def pool():
        handles.append(object())
        return handles[-1]

    monkeypatch.setattr(graphs.GraphCache, "accepts", staticmethod(lambda device: True))
    monkeypatch.setattr(graphs.Segments, "_new_graph", staticmethod(ranks.FakeGraph))
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)
    monkeypatch.setattr(torch.cuda, "empty_cache", lambda: None)
    monkeypatch.setattr(torch.cuda, "graph_pool_handle", pool)
    monkeypatch.setattr(torch.cuda, "device", _NoDevice)
    ranks.FakeGraph.log.clear()
    yield handles


def test_hetero_graphs_share_one_pool_a_scope(monkeypatch):
    """C13's bound: a HeteroTrainer's gradient graphs of one scope over five
    share sizes all draw on one pool, in the thread_local mode (no mesh),
    and write their gradients into one set of buffers, so no size keeps
    gradient memory of its own; another scope takes another pool and
    buffers."""
    from repro_torch.core import discover
    from repro_torch.data import SyntheticTokens
    from repro_torch.models import get_model
    from repro_torch.models.params import materialize
    from repro_torch.train.hetero import HeteroTrainer

    cfg = dataclasses.replace(reduced(get_config("qwen1.5-4b")), compute_dtype="float32")
    api = get_model(cfg)
    params = materialize(api.param_spec(cfg), torch.Generator().manual_seed(0), torch.float32,
                         "cpu")
    ds = SyntheticTokens(cfg, 6, 8, seed=0)
    batch = next(ds)
    with fake_card(monkeypatch) as handles:
        trainer = HeteroTrainer(cfg, api, [g for g in discover() if g.device.type == "cpu"][:1])
        try:
            outs = {}
            for scope in ("pod-a", "pod-b"):
                for n in range(1, 6):
                    part = {k: v[:n] for k, v in batch.items()}
                    loss, _ = trainer.grads(params, part, "cpu", scope=scope)
                    assert np.isfinite(loss)
            cache = trainer._graphs[torch.device("cpu")]
            for key, entry in cache._entries.items():
                scope = key[5]
                outs.setdefault(scope, []).append(entry)
        finally:
            trainer.shutdown()
    assert len(handles) == 2 and cache.stats()["captures"] == 10
    pools = {scope: {g.pool for e in es for g in e.graph.graphs} for scope, es in outs.items()}
    assert all(len(p) == 1 for p in pools.values())
    assert pools["pod-a"] != pools["pod-b"]
    assert all(g.mode == "thread_local" for es in outs.values() for e in es
               for g in e.graph.graphs)
    for scope, es in outs.items():
        grads = [e.outputs[1:] for e in es]
        assert all(a is b for g in grads[1:] for a, b in zip(g, grads[0])), scope
    assert not any(a is b for a, b in zip(outs["pod-a"][0].outputs[1:],
                                          outs["pod-b"][0].outputs[1:]))


def test_graph_cache_pools_default_to_one_a_recording(monkeypatch):
    """Without ``pool_per_scope`` each recording takes a pool of its own,
    shared by its stretches only."""
    cache = graphs.GraphCache()
    with fake_card(monkeypatch) as handles:
        for n in (2, 3):
            x = torch.zeros(n)
            cache.bind("loop", 1, (), {"x": x}, lambda st, k: (st["x"] + 1,), scope="s")()
    assert len(handles) == 2 and cache.stats()["loops"]["loop"]["stretches"] == 1
    assert cache.stats()["loops"]["loop"]["collectives"] == 0


def test_graphed_tp_generate_matches_jax(tmp_path):
    """The slice as a whole against the JAX package: reduced qwen1.5-4b on
    a (model 2) world of CPU ranks, one-shot generate with graph=True under
    the replay emulation, its tokens equal to the JAX ``make_generate``'s
    on the same weights and prompt."""
    import jax
    import jax.numpy as jnp

    from repro import configs as jconfigs
    from repro.models import get_model as jax_get_model
    from repro.models.params import materialize as jax_materialize
    from repro.serve.step import make_generate as jax_make_generate

    jcfg = dataclasses.replace(jconfigs.reduced(jconfigs.get_config("qwen1.5-4b")),
                               kernel_impl="reference", compute_dtype="float32")
    japi = jax_get_model(jcfg)
    jparams = jax_materialize(japi.param_spec(jcfg), jax.random.PRNGKey(0), jnp.float32)
    np_params = jax.tree_util.tree_map(np.asarray, jparams)
    tokens = np.random.default_rng(9).integers(0, jcfg.vocab, (ranks.BATCH, ranks.PROMPT)
                                               ).astype(np.int32)
    want = np.asarray(jax_make_generate(jcfg, japi)(jparams, {"tokens": jnp.asarray(tokens)},
                                                    ranks.GEN))
    res = spawn_world(ranks.tp_generate_from, 2, "cpu", tmp_path / "store",
                      (np_params, tokens))
    for r in res:
        assert r["replays"] == 4  # prefill and chain, two calls
        for toks in r["tokens"]:
            np.testing.assert_array_equal(toks.numpy(), want)
