"""Rank functions of tests/test_torch_mesh_graph.py's world: the mesh steps
that the port records as CUDA graphs, on a gloo world of 2 CPU ranks.

The ranks import this module (and ``_host_reads``), never JAX nor the JAX
package.  One world runs every case, over two meshes of its 2 ranks:
``dp`` (data 2, model 1) and ``tp`` (data 1, model 2)."""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from _host_reads import DECODE_EXEMPT, HostReadAudit
from repro_torch.configs import get_config, reduced
from repro_torch.distributed import sharding as S
from repro_torch.kernels import _build
from repro_torch.launch import mesh as M
from repro_torch.models import get_model
from repro_torch.models.params import materialize, tree_leaves
from repro_torch.serve import graphs

# name -> (arch, cfg fields, the mesh it runs on)
TRAIN = {
    "dp": ("qwen1.5-4b", {"remat": "dots"}, "dp"),
    "dp-zero1": ("qwen1.5-4b", {"remat": "dots", "zero1": True}, "dp"),
    "tp-heads": ("qwen1.5-4b", {"remat": "dots"}, "tp"),
    "tp-qheads-straddle": ("internlm2-20b", {"remat": "dots", "n_heads": 6, "n_kv_heads": 3},
                           "tp"),
}
GENERATE = {
    "tp-generate": ("qwen1.5-4b", {}, "tp"),
    "ep-generate": ("arctic-480b", {"ep_shard_map": True}, "tp"),
    "seq-generate": ("internlm2-20b", {"seq_shard_cache": True}, "tp"),
}
BATCH, SEQ, PROMPT, GEN = 4, 8, 8, 4


def config(arch, over):
    return dataclasses.replace(reduced(get_config(arch)), kernel_impl="cuda",
                               compute_dtype="float32", **over)


class StepReplay(graphs.GraphCache):
    """A GraphCache that "captures" on the CPU as the card does, running
    nothing; each replay runs the body on the static buffers, its
    collectives issued and counted as a segmented replay's nodes are."""

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


class CPUReplay(graphs.GraphCache):
    """One-shot generate's GraphCache on the CPU: capture runs the loop on
    clones of its static buffers (its collectives issued, as the warm-up
    on the card issues them), a replay reruns it on the buffers and copies
    its results into the captured outputs."""

    @staticmethod
    def accepts(device):
        return True

    def _record(self, statics, body):
        outputs = body(graphs._rebuild(statics, lambda r, i, s: s.clone()))

        class Replay:
            @staticmethod
            def replay():
                with _build.recording():
                    results = body(statics)
                for o, r in zip(outputs, results):
                    o.copy_(r)

        return Replay(), outputs, {}


class FakeGraph:
    """A CUDA graph's capture calls, logged: ``replay`` runs nothing."""

    log: list = []

    def capture_begin(self, pool=None, capture_error_mode="global"):
        self.pool, self.mode = pool, capture_error_mode
        FakeGraph.log.append(("begin", self))

    def capture_end(self):
        FakeGraph.log.append(("end", self))

    def replay(self):
        FakeGraph.log.append(("replay", self))


class FakeSegments(graphs.Segments):
    @staticmethod
    def _new_graph():
        return FakeGraph()


def train_setup(name, meshes, dev):
    from repro_torch.data import SyntheticTokens, rank_batch
    from repro_torch.launch.train import build_state

    arch, over, which = TRAIN[name]
    mesh = meshes[which]
    S.set_current_mesh(mesh)
    cfg = config(arch, over)
    api = get_model(cfg)
    state, _ = build_state(cfg, api, dev, 0, mesh)
    ds = SyntheticTokens(cfg, BATCH, SEQ, seed=3)
    batches = [rank_batch(next(ds), mesh, {"tokens": ("batch", None)}, dev) for _ in range(3)]
    return cfg, api, state, batches, mesh


def generate_setup(name, meshes, dev):
    from repro_torch.data import rank_batch
    from repro_torch.train.step import state_placements

    arch, over, which = GENERATE[name]
    mesh = meshes[which]
    S.set_current_mesh(mesh)
    cfg = config(arch, over)
    api = get_model(cfg)
    full = materialize(api.param_spec(cfg), torch.Generator(device=dev).manual_seed(0),
                       torch.float32, dev)
    params = S.shard_tree(full, state_placements(cfg, api, mesh)[1]["params"], mesh)
    tokens = np.random.default_rng(5).integers(0, cfg.vocab, (BATCH, PROMPT)).astype(np.int32)
    batch = rank_batch({"tokens": tokens}, mesh, {"tokens": ("batch", None)}, dev)
    return cfg, api, params, batch, mesh


def audit(fn, exempt=None) -> str | None:
    """None where ``fn`` reads no host under :class:`HostReadAudit`, else
    the audit's message."""
    try:
        with HostReadAudit(exempt):
            fn()
    except AssertionError as e:
        return str(e)
    return None


def audit_train(name, meshes, dev):
    """The second step of ``name`` under the audit (the first, as on the
    card, runs eagerly before the capture)."""
    from repro_torch.train import make_train_step

    cfg, api, state, batches, mesh = train_setup(name, meshes, dev)
    step = make_train_step(cfg, api, mesh=mesh)
    step(state, batches[0])
    return audit(lambda: step(state, batches[1]))


def audit_generate(name, meshes, dev):
    from repro_torch.serve.step import make_generate

    cfg, api, params, batch, _ = generate_setup(name, meshes, dev)
    gen = make_generate(cfg, api)
    gen(params, batch, GEN)
    return audit(lambda: gen(params, batch, GEN), DECODE_EXEMPT)


def leaves(state):
    return (tree_leaves(state["params"]) + tree_leaves(state["opt"]["m"])
            + tree_leaves(state["opt"]["v"]) + [state["step"]])


def replay_train(name, meshes, dev):
    """Three steps of ``make_train_step(graph=True)`` under
    :class:`StepReplay` (an eager step, the capture, two replays) against
    three of ``graph=False`` from the same state: the losses, learning
    rates and every leaf after, bitwise; each step's ``Mesh.stats``; the
    storage of every leaf kept; the graph's counters."""
    from repro_torch.train import make_train_step
    from repro_torch.train import step as tstep

    out = {}
    for graph in (True, False):
        cfg, api, state, batches, mesh = train_setup(name, meshes, dev)
        ptrs = [t.data_ptr() for t in leaves(state)]
        real = tstep.GraphCache
        tstep.GraphCache = StepReplay
        try:
            step = make_train_step(cfg, api, mesh=mesh, graph=graph)
        finally:
            tstep.GraphCache = real
        losses, stats = [], []
        mesh.reset_stats()
        for b in batches:
            st, m = step(state, b)
            losses.append((m["loss"].clone(), m["lr"].clone()))
            stats.append(mesh.reset_stats())
        out[graph] = {"losses": losses, "stats": stats, "leaves": [t.clone() for t in leaves(st)],
                      "in_place": [t.data_ptr() for t in leaves(st)] == ptrs,
                      "step": int(st["step"]),
                      "graph": step.graphs.stats() if graph else None}
    g, e = out[True], out[False]
    return {"losses_bitwise": all(torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
                                  for a, b in zip(g["losses"], e["losses"])),
            "leaves_bitwise": all(torch.equal(a, b) for a, b in zip(g["leaves"], e["leaves"])),
            "stats": (g["stats"], e["stats"]), "in_place": g["in_place"], "step": g["step"],
            "counters": (g["graph"]["captures"], g["graph"]["replays"])}


def replay_generate(name, meshes, dev):
    """One-shot generate with ``graph=True`` under :class:`CPUReplay` (the
    prefill and chain graphs' static cache the rank's slice) against
    ``graph=False``, twice each: tokens bitwise, and the second call's
    ``Mesh.stats`` (a replay's) equal to an eager call's."""
    from repro_torch.serve import step as sstep

    out = {}
    for graph in (True, False):
        cfg, api, params, batch, mesh = generate_setup(name, meshes, dev)
        real = sstep.GraphCache
        sstep.GraphCache = CPUReplay
        try:
            gen = sstep.make_generate(cfg, api, graph=graph)
        finally:
            sstep.GraphCache = real
        toks, stats = [], []
        for _ in range(2):
            mesh.reset_stats()
            toks.append(gen(params, batch, GEN).clone())
            stats.append(mesh.reset_stats())
        out[graph] = (toks, stats, gen.graphs.stats()["replays"] if graph else 0)
    return {"tokens_bitwise": all(torch.equal(a, b) for a, b in zip(out[True][0], out[False][0])),
            "stats": (out[True][1][1], out[False][1][1]), "replays": out[True][2],
            "shape": tuple(out[True][0][0].shape)}


def segments(meshes, dev):
    """The segmented recording itself, with graphs that record nothing
    (:class:`FakeGraph`): a body of two all_reduces and an all_gather on
    the dp mesh records 4 stretches and 3 nodes, one pool, and issues no
    collective; two replays issue them, in order, on the tensors the
    capture saw, each counted in ``Mesh.stats``."""
    mesh = meshes["dp"]
    rank = mesh.coord["data"]
    x = torch.full((3,), float(rank + 1))
    mesh.reset_stats()
    FakeGraph.log.clear()
    pool = object()
    rec = FakeSegments(None, pool, "relaxed")
    with rec:
        mesh.all_reduce(x, ("data",))
        mesh.all_gather(x, ("data",), 0)
        mesh.all_reduce(x, ("data",), "max")
    captured = {"x": x.clone(), "stats": mesh.reset_stats(), "open": dict(M.RECORDINGS),
                "log": [k for k, _ in FakeGraph.log]}
    FakeGraph.log.clear()
    rec.replay()
    first = {"x": x.clone(), "parts": [p.clone() for p in rec.nodes[1].parts],
             "kinds": [n.kind for n in rec.nodes], "stats": mesh.reset_stats(),
             "log": [k for k, _ in FakeGraph.log]}
    rec.replay()
    return {"stretches": rec.stretches, "collectives": rec.collectives,
            "pools": [g.pool is pool for g in rec.graphs], "modes": [g.mode for g in rec.graphs],
            "captured": captured, "first": first, "second_x": x.clone(),
            "second_stats": mesh.reset_stats()}


def world(rank, world_size, dev):
    """Every case of the test on this rank; each result under its name."""
    meshes = {"dp": M.make_mesh((2, 1), ("data", "model"), dev),
              "tp": M.make_mesh((1, 2), ("data", "model"), dev)}
    out = {"segments": segments(meshes, dev)}
    for name in TRAIN:
        out[f"audit/{name}"] = audit_train(name, meshes, dev)
    for name in GENERATE:
        out[f"audit/{name}"] = audit_generate(name, meshes, dev)
    for name in ("dp", "dp-zero1", "tp-heads"):
        out[f"replay/{name}"] = replay_train(name, meshes, dev)
    for name in ("tp-generate", "seq-generate"):
        out[f"replay/{name}"] = replay_generate(name, meshes, dev)
    S.set_current_mesh(None)
    return out


def tp_generate_from(rank, world_size, dev, np_params, tokens):
    """Reduced qwen1.5-4b on (model 2) from the JAX package's weights
    (numpy), one-shot generate with ``graph=True`` under
    :class:`CPUReplay`, called twice (the capture, then replays): both
    calls' tokens and the replays made."""
    from repro_torch.data import rank_batch
    from repro_torch.models.params import load_jax_params
    from repro_torch.serve import step as sstep
    from repro_torch.train.step import state_placements

    mesh = M.make_mesh((1, 2), ("data", "model"), dev)
    S.set_current_mesh(mesh)
    cfg = config("qwen1.5-4b", {})
    api = get_model(cfg)
    params = S.shard_tree(load_jax_params(np_params, cfg, dev),
                          state_placements(cfg, api, mesh)[1]["params"], mesh)
    real = sstep.GraphCache
    sstep.GraphCache = CPUReplay
    try:
        gen = sstep.make_generate(cfg, api, graph=True)
    finally:
        sstep.GraphCache = real
    batch = rank_batch({"tokens": tokens}, mesh, {"tokens": ("batch", None)}, dev)
    toks = [gen(params, batch, GEN).clone() for _ in range(2)]
    S.set_current_mesh(None)
    return {"tokens": toks, "replays": gen.graphs.stats()["replays"]}
