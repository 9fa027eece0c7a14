"""AdamW, as the JAX package's ``optim/adamw.py`` (no optimizer library).

The optimizer state is a Spec tree like the parameters' (``m`` and ``v``
in float32), materialized with them.  ``zero1`` (ZeRO-1: m and v sharded
over the data axis) needs a device mesh (ROADMAP.md A11) and is refused.

:func:`adamw_update` computes the reference's step in float32 -- the
global-norm clip, t = step + 1, the bias corrections and the decoupled
weight decay -- and writes the new parameters, m and v into their tensors,
leaf by leaf, as the JAX launcher's donated state: at 2.36 B parameters a
second copy of the state would not fit beside the first.
"""
from __future__ import annotations

import math

import torch

from repro_torch.models.params import Spec, tree_leaves, tree_map

B1, B2, EPS = 0.9, 0.95, 1e-8


def adamw_init_spec(param_spec_tree, *, zero1: bool = False, data_par: int = 1,
                    state_dtype: str = "float32") -> dict:
    """Spec tree for (m, v), zeros of ``state_dtype``.  The step counter is
    added by ``train.step.state_spec``."""
    if zero1:
        raise NotImplementedError(
            "zero1 shards m and v over the data axis of a device mesh, which the "
            "port does not have yet (ROADMAP.md A11)")

    def mk(s: Spec) -> Spec:
        return Spec(s.shape, "zeros", None, state_dtype)

    return {"m": tree_map(mk, param_spec_tree), "v": tree_map(mk, param_spec_tree)}


def _f32(x, device=None) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32, device=device)


def lr_schedule(step, *, peak: float = 3e-4, warmup: int = 100,
                decay_steps: int = 10_000) -> torch.Tensor:
    """Linear warmup to ``peak`` over ``warmup`` steps, then a cosine decay
    to 0 at ``decay_steps``: a float32 0-d tensor on ``step``'s device."""
    s = _f32(step, step.device if isinstance(step, torch.Tensor) else None)
    warm = peak * (s + 1) / warmup
    prog = torch.clamp((s - warmup) / max(decay_steps - warmup, 1), 0.0, 1.0)
    cos = peak * 0.5 * (1.0 + torch.cos(math.pi * prog))
    return torch.where(s < warmup, warm, cos).float()


@torch.no_grad()
def adamw_update(params, grads, opt_state, step, *, lr, weight_decay: float = 0.01,
                 grad_clip: float = 1.0):
    """One AdamW step of ``params`` by ``grads`` (same tree), at 0-based
    ``step``.  The parameters, m and v are updated in place, one leaf at a
    time, and returned as ``(params, {"m", "v"})``."""
    leaves = tree_leaves(grads)
    dev = leaves[0].device
    gnorm = torch.sqrt(sum(torch.sum(torch.square(g.float())) for g in leaves))
    scale = torch.clamp(grad_clip / torch.clamp(gnorm, min=1e-12), max=1.0)
    t = _f32(step, dev) + 1.0
    bc1 = 1.0 - torch.pow(_f32(B1, dev), t)
    bc2 = 1.0 - torch.pow(_f32(B2, dev), t)
    lr = _f32(lr, dev)
    for p, g, m, v in zip(tree_leaves(params), leaves, tree_leaves(opt_state["m"]),
                          tree_leaves(opt_state["v"])):
        g = g.float() * scale
        m_new = B1 * m.float() + (1 - B1) * g
        v_new = B2 * v.float() + (1 - B2) * torch.square(g)
        del g
        update = (m_new / bc1) / (torch.sqrt(v_new / bc2) + EPS)
        m.copy_(m_new)
        v.copy_(v_new)
        del m_new, v_new
        p32 = p.float()
        p.copy_(p32 - lr * (update + weight_decay * p32))
    return params, opt_state
