"""The train step: loss -> gradients (microbatched) -> AdamW.

The JAX package's step is one jitted SPMD program; here it is the eager
sequence of the same computations on one device.  ``cfg.microbatches`` > 1
splits the batch as ``x.reshape(nmb, B // nmb, ...)`` and sums the losses
and gradients over the microbatches, then divides both by ``nmb``, as the
reference's ``lax.scan``.  The state is ``{"params", "opt": {"m", "v"},
"step"}``, the JAX tree's keys; the step updates it in place (the JAX
launcher donates it) and returns it with ``step + 1``.
"""
from __future__ import annotations

from typing import Any, Dict

import torch

from repro_torch.models.params import Spec, tree_leaves, tree_unflatten
from repro_torch.optim import adamw_init_spec, adamw_update, lr_schedule

TrainState = Dict[str, Any]  # {"params", "opt": {"m","v"}, "step"}


def state_spec(cfg, param_spec_tree) -> dict:
    """Spec tree of the whole train state, for ``materialize``."""
    return {
        "params": param_spec_tree,
        "opt": adamw_init_spec(param_spec_tree, zero1=cfg.zero1),
        "step": Spec((), "zeros", None, "int32"),
    }


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


def make_train_step(cfg, api, *, lr_kwargs: dict | None = None):
    """``train_step(state, batch) -> (state, {"loss", "lr"})``: the
    gradients of ``api.forward_train`` (which casts the float32 masters to
    the compute dtype), then one AdamW step at ``lr_schedule(step)``.
    ``batch`` holds tensors on the state's device."""
    lr_kwargs = lr_kwargs or {}

    def train_step(state: TrainState, batch) -> tuple[TrainState, dict]:
        params = state["params"]
        loss, grads = loss_and_grads(api, cfg, params, batch)
        lr = lr_schedule(state["step"], **lr_kwargs)
        grads = tree_unflatten(params, grads)
        new_params, new_opt = adamw_update(params, grads, state["opt"], state["step"], lr=lr)
        del grads
        new_state = {"params": new_params, "opt": new_opt, "step": state["step"] + 1}
        return new_state, {"loss": loss, "lr": lr}

    return train_step
