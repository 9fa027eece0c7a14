"""The train step: loss -> gradients (microbatched) -> AdamW.

The JAX launcher runs its step as one jitted program with the state
donated (``jax.jit(make_train_step(...), donate_argnums=(0,))``), with or
without a mesh, and so does the elastic runner.  Here the step is the
sequence of the same computations, and on the card the whole of it is
replayed from CUDA graphs (:func:`make_train_step`): one graph without a
mesh, and under a mesh one graph per stretch between two of the mesh's
collectives, the collectives issued between the replays
(``serve/graphs.Segments``).
``cfg.microbatches`` > 1 splits the batch as ``x.reshape(nmb, B // nmb,
...)`` and sums the losses and gradients over the microbatches, then
divides both by ``nmb``, as the reference's ``lax.scan``.  The state is
``{"params", "opt": {"m", "v"}, "step"}``, the JAX tree's keys; the step
updates every leaf in place, the step counter too (``add_``: a graph
owns its address), and returns the same leaves.

Under a mesh the step takes the rank's slice of the global batch (split
over the batch axes, ``data.ShardedLoader``), and after the microbatches
the loss and every gradient are all-reduced and averaged over the batch
axes: the reduction GSPMD generates for the reference.  Every rank then
holds the global batch's gradients whole.
"""
from __future__ import annotations

from typing import Any, Dict

import torch

from repro_torch.distributed.sharding import axes_of, batch_axes, current_mesh, rank_placements
from repro_torch.models.params import Spec, tree_leaves, tree_unflatten
from repro_torch.optim import adamw_init_spec, adamw_update, lr_schedule
from repro_torch.serve.graphs import GraphCache

TrainState = Dict[str, Any]  # {"params", "opt": {"m","v"}, "step"}


def state_spec(cfg, param_spec_tree, data_par: int = 1) -> dict:
    """Spec tree of the whole train state, for ``materialize``; under
    ``cfg.zero1`` m and v carry "batch" on the dim ZeRO-1 shards over
    ``data_par`` ranks."""
    return {
        "params": param_spec_tree,
        "opt": adamw_init_spec(param_spec_tree, zero1=cfg.zero1, data_par=data_par),
        "step": Spec((), "zeros", None, "int32", ()),
    }


def state_placements(cfg, api, mesh):
    """(Spec tree of the train state on ``mesh``, the port's placement of
    each leaf): the experts sliced over "model" under expert parallelism,
    m and v over the batch axes under ZeRO-1, everything else whole."""
    from repro_torch.launch.mesh import data_par, model_par

    sspec = state_spec(cfg, api.param_spec(cfg, model_par(mesh)), data_par(mesh))
    return sspec, rank_placements(cfg, sspec, mesh, "state")[0]


def zero1_dims(opt_placements, mesh) -> list | None:
    """Each leaf's dim that ZeRO-1 slices over the batch axes (None where m
    and v are whole), in ``tree_leaves`` order; None without one."""
    bax = batch_axes(mesh) if mesh is not None else None
    if not bax:
        return None
    dims = [next((i for i, r in enumerate(sh) if set(bax) <= set(axes_of(r))), None)
            for sh in tree_leaves(opt_placements["m"])]
    return dims if any(d is not None for d in dims) else None


def grad_axes(param_placements) -> list | None:
    """The mesh axes each parameter leaf (and its gradient) is sliced over,
    in ``tree_leaves`` order (``()`` for a whole leaf); None when every
    leaf is whole."""
    axes = [tuple(a for r in sh for a in axes_of(r)) for sh in tree_leaves(param_placements)]
    return axes if any(axes) else None


def reduce_over_batch(loss, grads: list, mesh):
    """The loss and gradients averaged over the mesh's batch axes (each
    all-reduced, then divided by the ranks), in place."""
    bax = batch_axes(mesh) if mesh is not None else None
    if not bax or mesh.size(bax) == 1:
        return loss, grads
    n = mesh.size(bax)
    for t in [loss] + list(grads):
        mesh.all_reduce(t, bax).div_(n)
    return loss, grads


def microbatches(batch: dict, nmb: int) -> list:
    """``batch`` split into ``nmb`` consecutive slices of its rows."""
    if nmb <= 1:
        return [batch]
    b = batch["tokens"].shape[0]
    if b % nmb:
        raise ValueError(f"batch {b} does not split into {nmb} microbatches")
    return [{k: v.reshape(nmb, b // nmb, *v.shape[1:])[i] for k, v in batch.items()}
            for i in range(nmb)]


def loss_and_grads(api, cfg, params, batch):
    """(mean loss, gradients as a list in ``tree_leaves`` order) of
    ``forward_train`` over ``cfg.microbatches`` microbatches of ``batch``.
    Each microbatch's gradients accumulate in the masters' ``.grad``
    (leaf by leaf, as autograd produces them: no second copy of the
    gradients is held); the masters are left as they were found, with no
    ``.grad`` and no ``requires_grad``."""
    leaves = tree_leaves(params)
    nmb = max(cfg.microbatches, 1)
    for p in leaves:
        p.grad = None
        p.requires_grad_(True)
    try:
        loss = torch.zeros((), dtype=torch.float32, device=leaves[0].device)
        for mb in microbatches(batch, nmb):
            lm = api.forward_train(params, mb, cfg)
            lm.backward()
            loss = loss + lm.detach()
        grads = [p.grad if p.grad is not None else torch.zeros_like(p) for p in leaves]
    finally:
        for p in leaves:
            p.grad = None
            p.requires_grad_(False)
    if nmb > 1:
        loss = loss / nmb
        for g in grads:
            g.div_(nmb)
    return loss, grads


def make_train_step(cfg, api, *, lr_kwargs: dict | None = None, mesh=None,
                    graph: bool = True):
    """``train_step(state, batch) -> (state, {"loss", "lr"})``: the
    gradients of ``api.forward_train`` (which casts the float32 masters to
    the compute dtype), then one AdamW step at ``lr_schedule(step)``, the
    state updated in place.  ``batch`` holds tensors on the state's
    device.  ``mesh`` (the current mesh by default, read when the step is
    made): ``batch`` is the rank's slice, the loss and gradients are
    averaged over the batch axes, the clip's norm covers the leaves sliced
    over "model" (the experts under expert parallelism), and under
    ``cfg.zero1`` the update is ZeRO-1's.

    ``graph=True``, the counterpart of the JAX launcher's ``jax.jit``: on
    CUDA tensors the whole step -- every microbatch's forward and
    backward, the mean, the schedule, the clip and AdamW, and under a mesh
    the batch axes' reduction, ZeRO-1's gather and the tensor-parallel
    collectives of the forward and the backward -- is recorded once per
    key (:func:`graph_key`: the batch leaves' shapes and dtypes, the cfg
    fields that shape the step, the mesh's shape, axes and this rank's
    coordinate, and the identity of the state's leaves) and replayed for
    every later step: one CUDA graph without a mesh, and under one a
    graph per stretch between two collectives, each collective issued
    eagerly between two replays on the tensors the capture saw
    (``serve/graphs.Segments``; the mesh's ``stats`` count them as the
    eager step's).
    The first step of a key runs eagerly on the state, counted as a step
    (the graph's warm-up: a warm-up inside the capture would be an extra,
    uncounted AdamW step); the capture follows it, executing nothing, and
    every later step replays.  The graph reads the batch from static
    buffers, each leaf copied in unless it is that buffer, and updates the
    caller's params, m, v and step in place, as the JAX launcher donates
    them; the returned ``loss`` and ``lr`` are the graph's own tensors,
    which the next replay overwrites.  On CUDA a failed capture or replay
    raises; there is no eager fallback.  CPU tensors run the step
    eagerly.  ``graph=False`` runs every step eagerly."""
    lr_kwargs = lr_kwargs or {}
    mesh = mesh if mesh is not None else current_mesh()
    dims = axes = None
    if mesh is not None:
        places = state_placements(cfg, api, mesh)[1]
        dims = zero1_dims(places["opt"], mesh) if cfg.zero1 else None
        axes = grad_axes(places["params"])

    def eager_step(state: TrainState, batch) -> tuple[TrainState, dict]:
        params = state["params"]
        loss, grads = reduce_over_batch(*loss_and_grads(api, cfg, params, batch), mesh)
        lr = lr_schedule(state["step"], **lr_kwargs)
        grads = tree_unflatten(params, grads)
        adamw_update(params, grads, state["opt"], state["step"], lr=lr, mesh=mesh,
                     zero1_dims=dims, grad_axes=axes)
        del grads
        state["step"].add_(1)
        return {"params": params, "opt": state["opt"], "step": state["step"]}, \
            {"loss": loss, "lr": lr}

    if not graph:
        return eager_step
    graphs = GraphCache()
    warmed: set = set()

    def train_step(state: TrainState, batch) -> tuple[TrainState, dict]:
        if not graphs.accepts(next(iter(batch.values())).device):
            return eager_step(state, batch)
        inputs, consts = graph_inputs(state, batch)

        def body(statics, n):
            _, m = eager_step(state, {k: statics[k] for k in batch})
            return m["loss"], m["lr"]

        ints = graph_ints(cfg, mesh)
        key = graph_key(cfg, inputs, consts, mesh)
        if key not in warmed:
            out = eager_step(state, batch)
            # The eager step's cached blocks go back to the card before the
            # graph's private pool is drawn.
            torch.cuda.empty_cache()
            graphs.capture("train_step", 1, ints, inputs, body, consts, warmup=False)
            warmed.add(key)
            return out
        loss, lr = graphs.bind("train_step", 1, ints, inputs, body, consts, warmup=False)()
        return {"params": state["params"], "opt": state["opt"], "step": state["step"]}, \
            {"loss": loss, "lr": lr}

    train_step.graphs = graphs
    return train_step


def mesh_key(mesh) -> tuple:
    """A mesh as a graph's key sees it: its axes and shape and this rank's
    coordinate (``()`` without one), never an object's address."""
    if mesh is None:
        return ()
    return tuple((a, mesh.shape[a], mesh.coord[a]) for a in mesh.axis_names)


def graph_ints(cfg, mesh=None) -> tuple:
    """The cfg fields and the mesh (:func:`mesh_key`) that shape a train
    step's graph."""
    return (cfg.remat, max(cfg.microbatches, 1), cfg.kernel_impl, cfg.compute_dtype,
            cfg.zero1, mesh_key(mesh))


def graph_inputs(state: TrainState, batch: dict) -> tuple[dict, tuple]:
    """(the graph's inputs: the batch leaves by key, its consts: the
    state's params, m, v and step, whose leaves it addresses)."""
    return ({k: batch[k] for k in sorted(batch)},
            (state["params"], state["opt"]["m"], state["opt"]["v"], state["step"]))


def graph_key(cfg, inputs: dict, consts: tuple, mesh=None) -> tuple:
    """The train step graph's cache key (``GraphCache.key``): the batch
    leaves' shapes and dtypes, :func:`graph_ints` (with the mesh's shape,
    axes and this rank's coordinate), the device and the identity of every
    state leaf; never a batch leaf's or the mesh's address."""
    return GraphCache.key("train_step", 1, graph_ints(cfg, mesh), inputs, consts)
