"""Rank functions of the mesh tests' worlds (``launch.mesh.spawn_world``).

Spawned ranks import this module and nothing of the test that started
them, so it imports neither JAX nor the JAX package: every input arrives
as numpy (weights from the JAX package's ``materialize``), and the JAX
references are computed in the parent test process.  Each function is
``fn(rank, world, device, *args)`` and returns CPU tensors."""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.distributed import sharding as S
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import get_model
from repro_torch.models.params import load_jax_params, tree_leaves, tree_map, unstack


def _cpu(tree):
    return tree_map(lambda t: t.detach().cpu().clone(), tree)


def seq_decode(rank, world, dev, cfg, np_params, tokens, steps, max_seq):
    """Prefill ``tokens`` (B, S) and decode ``steps`` (list of (B, 1)) on a
    (data 2, model 2) mesh with the seq-sharded cache; returns each call's
    logits of this rank's rows and the collectives it issued."""
    mesh = make_mesh((2, 2), ("data", "model"), dev)
    S.set_current_mesh(mesh)
    cfg = dataclasses.replace(cfg, seq_shard_cache=True)
    api = get_model(cfg)
    params = load_jax_params(np_params, cfg, dev)
    from repro_torch.serve.step import zeros_cache

    cache = zeros_cache(cfg, api, tokens.shape[0], max_seq, device=dev, mesh=mesh)
    rows = S.named_sharding(mesh, ("batch", None), tokens.shape)
    logits, cache = api.prefill(params, {"tokens": S.rank_slice(torch.from_numpy(tokens), rows,
                                                                 mesh)}, cfg, cache)
    out = [logits]
    s = tokens.shape[1]
    for i, tok in enumerate(steps):
        logits, cache = api.decode(params, S.rank_slice(torch.from_numpy(tok), rows, mesh),
                                   s + i, cfg, cache)
        out.append(logits)
    return {"coord": mesh.coord, "logits": [t.cpu() for t in out],
            "cache_len": cache["k"].shape[2], "stats": mesh.reset_stats()}


def ep_world(rank, world, dev, cfg, np_params, h, batch):
    """Expert parallelism on a (data 2, model 2) mesh of reduced kimi:
    (a) the rank's partial of layer 0's ``moe_ffn_ep`` on its rows of ``h``
    (B, S, d) at the reference's capacity, with its drops; (b) the loss of
    ``batch`` and (c) the batch-averaged gradients, whole (the experts
    gathered over "model"), at capacity factor 100."""
    from repro_torch.models import moe
    from repro_torch.train.step import loss_and_grads, reduce_over_batch, state_placements

    mesh = make_mesh((2, 2), ("data", "model"), dev)
    S.set_current_mesh(mesh)
    cfg = dataclasses.replace(cfg, ep_shard_map=True)
    api = get_model(cfg)
    places = state_placements(cfg, api, mesh)[1]["params"]
    params = S.shard_tree(load_jax_params(np_params, cfg, dev), places, mesh)
    rows = S.named_sharding(mesh, ("batch", None, None), h.shape)
    h_loc = S.rank_slice(torch.from_numpy(h), rows, mesh).to(dev)
    partial = []
    reduce_from = moe.reduce_from
    moe.reduce_from = lambda x, m, a: (partial.append(x.detach().cpu().clone()),
                                       reduce_from(x, m, a))[1]
    try:
        lp = unstack(params["layers"], cfg.n_layers)[0]
        with moe.dropped_assignments() as drops:
            whole = moe.moe_ffn_ep(h_loc, lp, dataclasses.replace(cfg, kernel_impl="cuda"))
    finally:
        moe.reduce_from = reduce_from
    moe.CAPACITY_FACTOR = 100.0  # no drops: the unsharded MoE's values
    try:
        from repro_torch.data import rank_batch

        loc = rank_batch(batch, mesh, {"tokens": ("batch", None)}, dev)
        loss, grads = reduce_over_batch(*loss_and_grads(api, cfg, params, loc), mesh)
    finally:
        moe.CAPACITY_FACTOR = 1.25
    pl = tree_leaves(places)
    grads = [S.gather_leaf(g, sh, mesh) for g, sh in zip(grads, pl)]
    return {"coord": mesh.coord, "partial": partial[0], "whole": whole.cpu(),
            "drops": int(sum(int(d) for d in drops)), "loss": float(loss),
            "grads": [g.cpu() for g in grads],
            "expert_shape": tuple(lp["experts"]["w_up"].shape)}


def ep_train(rank, world, dev, cfg, np_params, batches, lr_kwargs):
    """Expert-parallel training of reduced kimi on a (data 2, model 2) mesh
    at no-drop capacity (factor 100), its dense leaves tensor-parallel:
    the clip's norm of the first batch's gradients (and of the leaves
    sliced over "model" alone, with their indices), then one train step a
    batch; returns the norms, each step's batch-averaged gradients and the
    parameters after each step, whole (gathered over "model")."""
    from repro_torch.data import rank_batch
    from repro_torch.models import moe
    from repro_torch.models.params import materialize
    from repro_torch.optim.adamw import global_norm
    from repro_torch.train import make_train_step
    from repro_torch.train.step import (grad_axes, loss_and_grads, reduce_over_batch,
                                        state_placements)

    mesh = make_mesh((2, 2), ("data", "model"), dev)
    S.set_current_mesh(mesh)
    cfg = dataclasses.replace(cfg, ep_shard_map=True)
    api = get_model(cfg)
    moe.CAPACITY_FACTOR = 100.0
    sspec, places = state_placements(cfg, api, mesh)
    state = materialize(sspec, torch.Generator().manual_seed(0), torch.float32, dev)
    state["params"] = load_jax_params(np_params, cfg, dev)
    state = S.shard_tree(state, places, mesh)
    locs = [rank_batch(b, mesh, {"tokens": ("batch", None)}, dev) for b in batches]
    _, grads = reduce_over_batch(*loss_and_grads(api, cfg, state["params"], locs[0]), mesh)
    axes = grad_axes(places["params"])
    norm = float(global_norm(grads, mesh, axes))
    sliced = [i for i, a in enumerate(axes) if a]
    expert_norm = float(global_norm([grads[i] for i in sliced], mesh, [axes[i] for i in sliced]))
    from repro_torch.train import step as train_step

    real, seen = train_step.reduce_over_batch, []

    def reduce_over_batch(loss, grads, m):  # keeps each step's averaged gradients
        loss, grads = real(loss, grads, m)
        seen.append([g.clone() for g in grads])
        return loss, grads

    train_step.reduce_over_batch = reduce_over_batch
    step_params = []
    try:
        step = make_train_step(cfg, api, mesh=mesh, lr_kwargs=lr_kwargs)
        for loc in locs:
            state, _ = step(state, loc)
            step_params.append(_cpu(S.gather_tree(state["params"], places["params"], mesh)))
    finally:
        train_step.reduce_over_batch = real
    pl = tree_leaves(places["params"])
    step_grads = [[S.gather_leaf(g, sh, mesh).cpu() for g, sh in zip(gs, pl)] for gs in seen]
    return {"coord": mesh.coord, "norm": norm, "sliced": sliced, "expert_norm": expert_norm,
            "step_grads": step_grads, "step_params": step_params, "params": step_params[-1]}


def dp_world(rank, world, dev, shape, axes, cfg, np_params, batch):
    """Data parallelism of reduced qwen on a mesh of ``shape`` (tensor
    parallelism too, where it has a model axis): the loss and
    batch-averaged gradients of ``batch``, then one train step with ZeRO-1
    off and on from the same state; returns the gradients and the
    parameters after each step whole (gathered over "model"), the losses,
    and whether the two steps' parameters equal bitwise."""
    from repro_torch.data import rank_batch
    from repro_torch.models.params import materialize
    from repro_torch.train import make_train_step
    from repro_torch.train.step import loss_and_grads, reduce_over_batch, state_placements

    mesh = make_mesh(shape, axes, dev)
    S.set_current_mesh(mesh)
    api = get_model(cfg)
    loc = rank_batch(batch, mesh, {"tokens": ("batch", None)}, dev)
    out = {"coord": mesh.coord}
    after = {}
    for zero1 in (False, True):
        c = dataclasses.replace(cfg, zero1=zero1)
        sspec, places = state_placements(c, api, mesh)
        state = materialize(sspec, torch.Generator().manual_seed(0), torch.float32, dev)
        state["params"] = load_jax_params(np_params, c, dev)
        state = S.shard_tree(state, places, mesh)
        if not zero1:
            loss, grads = reduce_over_batch(*loss_and_grads(api, c, state["params"], loc), mesh)
            out["loss"] = float(loss)
            out["grads"] = [S.gather_leaf(g, sh, mesh).cpu()
                            for g, sh in zip(grads, tree_leaves(places["params"]))]
        out[f"m_shape_zero1_{zero1}"] = tuple(tree_leaves(state["opt"]["m"])[0].shape)
        state, metrics = make_train_step(c, api, mesh=mesh)(state, loc)
        out[f"step_loss_zero1_{zero1}"] = float(metrics["loss"])
        after[zero1] = _cpu(S.gather_tree(state["params"], places["params"], mesh))
    out["bitwise"] = all(torch.equal(a, b) for a, b in zip(tree_leaves(after[False]),
                                                           tree_leaves(after[True])))
    out["params"] = after[True]
    out["stats"] = mesh.reset_stats()
    return out


def elastic_launcher(rank, world, dev, argv, ckpt_dir, store):
    """Train through ``launch.train`` on a (data 2) world with a
    checkpoint, lose rank 1, and rebuild on rank 0 alone with
    ``ElasticRunner``; returns the trained and restored parameters, the
    cursors and the next step's loss."""
    from repro_torch.configs import get_config, reduced
    from repro_torch.data import SyntheticTokens, to_device
    from repro_torch.distributed.elastic import ElasticRunner
    from repro_torch.launch import train as launch_train
    from repro_torch.train import make_train_step, state_spec

    r = launch_train.main(argv + ["--ckpt", ckpt_dir])
    if rank != 0:
        torch.distributed.destroy_process_group()  # the lost rank leaves
        return {"lost": True}
    cfg = dataclasses.replace(reduced(get_config("qwen1.5-4b")), kernel_impl="reference")
    api = get_model(cfg)
    runner = ElasticRunner(cfg, api, step_factory=make_train_step, ckpt_dir=ckpt_dir,
                           model_par=1, device=dev,
                           state_spec_fn=lambda c, plan: state_spec(c, api.param_spec(c, 1)))
    mesh, restored, extra = runner.on_failure([0], f"file://{store}")
    before = _cpu(restored["params"])  # the step updates the state in place
    ds = SyntheticTokens(cfg, 4, 16, seed=0)
    ds.seek(extra["data_cursor"])
    _, m = runner.step_fn(restored, to_device(next(ds), dev))
    return {"trained": _cpu(r["state"]["params"]), "restored": before,
            "restored_world": dict(mesh.shape), "cursor": extra["data_cursor"],
            "launcher_cursor": r["data_cursor"], "next_loss": float(m["loss"]),
            "losses": r["losses"]}


def elastic_zero1(rank, world, dev, cfg, ckpt_dir, store, batches):
    """ZeRO-1 on a (data 2) world: two train steps, a checkpoint (m and v
    gathered to the writer leaf by leaf: the writer's count of files
    written as each leaf's gather starts), then the world lost down to
    rank 0 and the state restored there whole; returns the gathered state
    before and the restored state after."""
    from repro_torch.ckpt import save_checkpoint
    from repro_torch.data import rank_batch
    from repro_torch.distributed.elastic import ElasticRunner
    from repro_torch.models.params import materialize
    from repro_torch.train import make_train_step, state_spec
    from repro_torch.train.step import state_placements

    mesh = make_mesh((2, 1), ("data", "model"), dev)
    S.set_current_mesh(mesh)
    api = get_model(cfg)
    sspec, places = state_placements(cfg, api, mesh)
    state = S.shard_tree(materialize(sspec, torch.Generator().manual_seed(3), torch.float32,
                                     dev), places, mesh)
    step = make_train_step(cfg, api, mesh=mesh)
    for b in batches:
        state, _ = step(state, rank_batch(b, mesh, {"tokens": ("batch", None)}, dev))
    m_local = tuple(tree_leaves(state["opt"]["m"])[0].shape)
    whole = _cpu(S.gather_tree(state, places, mesh))
    from pathlib import Path

    tmp, written, gather = Path(ckpt_dir) / ".tmp_step_2", [], S.gather_leaf
    S.gather_leaf = lambda x, sh, m: (written.append(len(list(tmp.glob("*.npy")))
                                                     if tmp.exists() else -1),
                                      gather(x, sh, m))[1]
    try:
        save_checkpoint(ckpt_dir, 2, state, {"data_cursor": 2}, shardings=places, mesh=mesh)
    finally:
        S.gather_leaf = gather
    if rank != 0:
        torch.distributed.destroy_process_group()  # the lost rank leaves
        return {"lost": True}
    runner = ElasticRunner(cfg, api, step_factory=make_train_step, ckpt_dir=ckpt_dir,
                           model_par=1, device=dev,
                           state_spec_fn=lambda c, plan: state_spec(
                               c, api.param_spec(c, 1), plan.n_devices // plan.shape[-1]))
    mesh1, restored, extra = runner.on_failure([0], f"file://{store}")
    return {"whole": whole, "restored": _cpu(restored), "m_local": m_local, "written": written,
            "cursor": extra["data_cursor"], "world": dict(mesh1.shape)}


def world_errors(rank, world, dev):
    """What a world refuses: a mesh whose size is not the world's."""
    try:
        make_mesh((4,), ("data",), dev)
    except ValueError as e:
        return str(e)
    return ""


def _vocab_whole(logits, cfg, mesh):
    """Logits whole over the vocabulary (gathered where the rank holds a
    slice of it)."""
    if logits.shape[-1] == cfg.vocab:
        return logits
    return mesh.all_gather(logits, ("model",), logits.dim() - 1)


def tp_case(mesh, dev, case):
    """One tensor-parallel case on this rank of ``mesh``: the model of
    ``case["cfg"]`` from the JAX weights ``case["params"]`` (numpy), each
    leaf sliced as ``state_placements`` places it; prefill of
    ``case["batch"]``'s rows and the teacher-forced decode ``case["steps"]``
    (logits gathered whole over the vocabulary, the greedy tokens across
    its slices, the head's replicated input), one-shot generate of
    ``case["generate"]`` tokens where the case asks for it, then one train
    step of ``case["train"]`` (its loss, the batch-averaged gradients and
    the parameters after it, whole).  ``case["capacity_factor"]`` sets the moe
    family's capacity for the whole case."""
    from repro_torch.data import rank_batch
    from repro_torch.models import layers as L
    from repro_torch.models import moe
    from repro_torch.models import transformer as T
    from repro_torch.models import whisper as W
    from repro_torch.models.params import materialize, tree_map_path
    from repro_torch.serve.step import prefix_len, zeros_cache
    from repro_torch.train import make_train_step
    from repro_torch.train import step as train_step
    from repro_torch.train.step import state_placements

    cfg = case["cfg"]
    api = get_model(cfg)
    factor, moe.CAPACITY_FACTOR = moe.CAPACITY_FACTOR, case.get("capacity_factor", 1.25)
    sspec, places = state_placements(cfg, api, mesh)
    params = S.shard_tree(load_jax_params(case["params"], cfg, dev), places["params"], mesh)
    shapes = {}
    tree_map_path(lambda p, t: shapes.__setitem__(p, tuple(t.shape)), params)
    entries = {k: ("batch",) + (None,) * (v.ndim - 1) for k, v in case["batch"].items()}
    loc = rank_batch(case["batch"], mesh, entries, dev)
    b, s = case["batch"]["tokens"].shape
    cache = zeros_cache(cfg, api, b, case["max_seq"], device=dev, mesh=mesh)
    hidden = []
    real_t, real_w = T.logits_fn, W.tied_head

    def logits_fn(params, x, cfg, impl=None):
        hidden.append(x.detach().cpu().clone())
        return real_t(params, x, cfg, impl)

    def tied_head(params, x, cfg, impl):
        hidden.append(x.detach().cpu().clone())
        return real_w(params, x, cfg, impl)

    T.logits_fn, W.tied_head = logits_fn, tied_head
    try:
        logits, cache = api.prefill(params, loc, cfg, cache)
        out, greedy = [logits], [L.vocab_argmax(logits[:, -1], cfg.vocab)]
        tok_sh = S.named_sharding(mesh, ("batch", None), (b, 1))
        for i, tok in enumerate(case["steps"]):
            t = S.rank_slice(torch.from_numpy(tok), tok_sh, mesh).to(dev)
            logits, cache = api.decode(params, t, prefix_len(cfg) + s + i, cfg, cache)
            out.append(logits)
            greedy.append(L.vocab_argmax(logits[:, -1], cfg.vocab))
    finally:
        T.logits_fn, W.tied_head = real_t, real_w
    if case.get("generate"):  # one-shot greedy generate of the rank's rows, under the mesh
        from repro_torch.serve import make_generate

        res_gen = make_generate(cfg, api)(params, loc, case["generate"]).cpu()
    res = {"shapes": shapes, "hidden": hidden,
           "logits": [_vocab_whole(x, cfg, mesh).cpu() for x in out],
           "greedy": [g.cpu() for g in greedy],
           "cache_shapes": [tuple(v.shape) for v in tree_leaves(cache)]}
    if case.get("generate"):
        res["generate"] = res_gen

    state = materialize(sspec, torch.Generator().manual_seed(0), torch.float32, dev)
    state["params"] = load_jax_params(case["params"], cfg, dev)
    state = S.shard_tree(state, places, mesh)
    tentries = {k: ("batch",) + (None,) * (v.ndim - 1) for k, v in case["train"].items()}
    real, seen = train_step.reduce_over_batch, []

    def reduce_over_batch(loss, grads, m):
        loss, grads = real(loss, grads, m)
        seen.append([g.clone() for g in grads])
        return loss, grads

    train_step.reduce_over_batch = reduce_over_batch
    try:
        state, metrics = make_train_step(cfg, api, mesh=mesh)(
            state, rank_batch(case["train"], mesh, tentries, dev))
    finally:
        train_step.reduce_over_batch = real
        moe.CAPACITY_FACTOR = factor
    pl = tree_leaves(places["params"])
    res.update(loss=float(metrics["loss"]),
               grads=[S.gather_leaf(g, sh, mesh).cpu() for g, sh in zip(seen[0], pl)],
               after=[S.gather_leaf(p, sh, mesh).cpu()
                      for p, sh in zip(tree_leaves(state["params"]), pl)])
    return res


def tp_world(rank, world, dev, shape, axes, cases, ties=None):
    """The tensor-parallel cases (:func:`tp_case`) on a mesh of ``shape``,
    and the greedy argmax of ``ties`` (rows over the whole vocabulary)
    from each rank's slice of them."""
    from repro_torch.models import layers as L

    mesh = make_mesh(shape, axes, dev)
    S.set_current_mesh(mesh)
    out = {"coord": mesh.coord,
           "cases": {c["name"]: tp_case(mesh, dev, c) for c in cases}}
    if ties is not None:
        t = torch.from_numpy(ties)
        n = t.shape[-1] // mesh.shape["model"]
        out["ties"] = L.vocab_argmax(t.narrow(-1, mesh.coord["model"] * n, n),
                                     t.shape[-1]).cpu()
    return out


def tp_checkpoint(rank, world, dev, cfg, np_params, batch, ckpt_dir):
    """One train step of ``cfg`` on a (data 1, model 2) mesh from the JAX
    weights, then a checkpoint of the state, each leaf gathered over
    "model" as it is written; returns the state after the step, whole."""
    from repro_torch.ckpt import save_checkpoint
    from repro_torch.data import rank_batch
    from repro_torch.models.params import materialize
    from repro_torch.train import make_train_step
    from repro_torch.train.step import state_placements

    mesh = make_mesh((1, 2), ("data", "model"), dev)
    S.set_current_mesh(mesh)
    api = get_model(cfg)
    sspec, places = state_placements(cfg, api, mesh)
    state = materialize(sspec, torch.Generator().manual_seed(0), torch.float32, dev)
    state["params"] = load_jax_params(np_params, cfg, dev)
    state = S.shard_tree(state, places, mesh)
    state, _ = make_train_step(cfg, api, mesh=mesh)(
        state, rank_batch(batch, mesh, {"tokens": ("batch", None)}, dev))
    save_checkpoint(ckpt_dir, 1, state, {"data_cursor": 1}, shardings=places, mesh=mesh)
    return {"whole": _cpu(S.gather_tree(state, places, mesh)),
            "sliced": tuple(state["params"]["layers"]["attn"]["wq"].shape)}
