"""AdamW, as the JAX package's ``optim/adamw.py`` (no optimizer library).

The optimizer state is a Spec tree like the parameters' (``m`` and ``v``
in float32), materialized with them.  ``zero1=True`` (ZeRO-1) shards m and
v over the batch axes of a mesh: for each leaf the largest replicated dim
that the data-parallel degree divides is given to "batch"
(:func:`_zero1_spec`, the reference's rule).

:func:`adamw_update` computes the reference's step in float32 -- the
global-norm clip, t = step + 1, the bias corrections and the decoupled
weight decay -- and writes the new parameters, m and v into their tensors,
leaf by leaf, as the JAX launcher's donated state: at 2.36 B parameters a
second copy of the state would not fit beside the first.  Under ZeRO-1
each data rank updates its slice of every leaf with its slices of m and v
(the clip from the all-reduced gradients, which every rank holds whole),
then ``all_gather``s the new slices: every operation of the update is
elementwise, so the parameters equal the replicated update's bit for bit.
Under expert parallelism a model rank holds E/par of the experts'
gradients: the clip's norm sums their squares over "model"
(:func:`global_norm`), so every rank clips by the whole tree's norm and
the leaves it holds whole stay equal on every model rank.
"""
from __future__ import annotations

import math

import torch

from repro_torch.models.params import Spec, tree_leaves, tree_map

B1, B2, EPS = 0.9, 0.95, 1e-8


def _zero1_spec(s: Spec, data_par: int) -> Spec:
    """``s`` with "batch" on its largest replicated dim that ``data_par``
    divides (the first of equal ones); unchanged when none does."""
    entries = list(s.pspec) if s.pspec else [None] * len(s.shape)
    entries += [None] * (len(s.shape) - len(entries))
    best, best_dim = -1, -1
    for i, (dim, e) in enumerate(zip(s.shape, entries)):
        if e is None and data_par > 1 and dim % data_par == 0 and dim > best_dim:
            best, best_dim = i, dim
    if best >= 0:
        entries[best] = "batch"  # resolves to the ("pod", "data") axes
    return Spec(s.shape, "zeros", None, s.dtype, tuple(entries))


def adamw_init_spec(param_spec_tree, *, zero1: bool = False, data_par: int = 1,
                    state_dtype: str = "float32") -> dict:
    """Spec tree for (m, v), zeros of ``state_dtype`` with the parameters'
    pspec entries (plus ZeRO-1's "batch" under ``zero1``).  The step
    counter is added by ``train.step.state_spec``."""

    def mk(s: Spec) -> Spec:
        out = Spec(s.shape, "zeros", None, state_dtype, s.pspec)
        return _zero1_spec(out, data_par) if zero1 else out

    return {"m": tree_map(mk, param_spec_tree), "v": tree_map(mk, param_spec_tree)}


def _f32(x, device=None) -> torch.Tensor:
    """``x`` as a float32 0-d tensor on ``device``: a tensor converted
    there, a Python number filled in by a kernel (never copied from the
    host, which a CUDA graph's capture refuses)."""
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=torch.float32)
    return torch.full((), x, dtype=torch.float32, device=device)


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
def global_norm(leaves, mesh=None, grad_axes=None) -> torch.Tensor:
    """The L2 norm of the whole gradient tree (a list of leaves), in
    float32.  ``grad_axes`` (a list like ``leaves``: the mesh axes a rank
    holds a leaf sliced over, ``()`` where it holds it whole): the squares
    of the sliced leaves are summed by axes and ``all_reduce``d over them,
    the whole leaves counted once, so every rank gets the norm of the
    whole tree.  Without ``grad_axes`` the reference's sum, leaf by
    leaf."""
    parts = {}
    for g, ax in zip(leaves, grad_axes or [()] * len(leaves)):
        sq = torch.sum(torch.square(g.float()))
        parts[tuple(ax)] = parts[tuple(ax)] + sq if tuple(ax) in parts else sq
    total = None
    for ax, sq in parts.items():  # leaf order: the same collectives on every rank
        if ax:
            sq = mesh.all_reduce(sq.clone(), ax)
        total = sq if total is None else total + sq
    return torch.sqrt(total)


@torch.no_grad()
def adamw_update(params, grads, opt_state, step, *, lr, weight_decay: float = 0.01,
                 grad_clip: float = 1.0, mesh=None, zero1_dims=None, grad_axes=None):
    """One AdamW step of ``params`` by ``grads`` (same tree), at 0-based
    ``step``.  The parameters, m and v are updated in place, one leaf at a
    time, and returned as ``(params, {"m", "v"})``.

    On a ``mesh``, ``grad_axes`` (a list in ``tree_leaves`` order) names
    the axes each leaf is sliced over (the experts over "model" under
    expert parallelism, ``()`` for a whole leaf): the clip's norm is the
    whole tree's (:func:`global_norm`), the same on every rank.  ZeRO-1:
    ``zero1_dims`` (a list in ``tree_leaves`` order, None for a leaf whose
    m and v are whole) names the dim each leaf's m and v slice over the
    ``mesh``'s batch axes; the rank updates that slice of the parameter and
    all-gathers the new slices over the batch axes."""
    leaves = tree_leaves(grads)
    if (zero1_dims is not None or grad_axes is not None) and mesh is None:
        raise ValueError("zero1 and sliced gradients need the mesh they slice over: "
                         "pass the mesh")
    dev = leaves[0].device
    gnorm = global_norm(leaves, mesh, grad_axes)
    scale = torch.clamp(grad_clip / torch.clamp(gnorm, min=1e-12), max=1.0)
    t = _f32(step, dev) + 1.0
    bc1 = 1.0 - torch.pow(_f32(B1, dev), t)
    bc2 = 1.0 - torch.pow(_f32(B2, dev), t)
    lr = _f32(lr, dev)
    dims = zero1_dims or [None] * len(leaves)
    for p, g, m, v, dim in zip(tree_leaves(params), leaves, tree_leaves(opt_state["m"]),
                               tree_leaves(opt_state["v"]), dims):
        whole = p
        if dim is not None:
            from repro_torch.distributed.sharding import batch_axes

            bax = batch_axes(mesh)
            n = p.shape[dim] // mesh.size(bax)
            p, g = (a.narrow(dim, mesh.index(bax) * n, n) for a in (p, g))
        g = g.float() * scale
        m_new = B1 * m.float() + (1 - B1) * g
        v_new = B2 * v.float() + (1 - B2) * torch.square(g)
        del g
        update = (m_new / bc1) / (torch.sqrt(v_new / bc2) + EPS)
        m.copy_(m_new)
        v.copy_(v_new)
        del m_new, v_new
        p32 = p.float()
        new = (p32 - lr * (update + weight_decay * p32)).to(p.dtype)
        if dim is not None:
            new = mesh.all_gather(new, batch_axes(mesh), dim)
        whole.copy_(new)
    return params, opt_state
