"""Parameter-definition trees.

A model is described once as a nested dict of :class:`Spec` leaves, as in
the JAX package; from that description come the materialized tensors and
the empty caches.  Layer-stacked leaves keep the JAX layout (a leading
``n_layers`` dim), so a JAX parameter tree loads leaf for leaf.

Each leaf carries the JAX package's ``pspec``: one logical entry a dim (None,
``"model"``, ``"batch"`` ...), which ``distributed/sharding.py`` resolves
against a device mesh.  The field comes last, as a keyword, so a Spec
written as ``Spec(shape, init, scale, dtype)`` keeps its meaning.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class Spec:
    """One parameter leaf: shape + init recipe."""

    shape: tuple[int, ...]
    init: str = "normal"  # normal | small_normal | zeros | ones | neg_ones | lambda_init
    scale: float | None = None  # stddev override for normal init
    dtype: str | None = None  # per-leaf dtype override (e.g. int32 cache pos)
    # One entry per dim: None (replicated) or a logical axis ("model", "batch").
    pspec: tuple = ()


def tree_map(fn: Callable, tree, *rest):
    """Map ``fn`` over the leaves of nested dicts (keys in sorted order)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in sorted(tree)}
    return fn(tree, *rest)


def tree_map_path(fn: Callable, tree, *rest, prefix: str = ""):
    """:func:`tree_map` with ``fn(path, leaf, ...)``: ``path`` the leaf's
    keys joined by ``/`` (``layers/attn/wq``)."""
    if isinstance(tree, dict):
        return {k: tree_map_path(fn, tree[k], *(r[k] for r in rest), prefix=f"{prefix}{k}/")
                for k in sorted(tree)}
    return fn(prefix[:-1], tree, *rest)


def tree_leaves(tree) -> list:
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    return [tree]


def cast_float(tree, dtype):
    """Floating leaves cast to ``dtype`` (others as they are): the train
    step's one cast of the float32 masters to the compute dtype, on the
    stacked leaves, so that autograd carries each gradient back to its
    master through the cast."""
    dt = _dtype(dtype)
    return tree_map(lambda a: a.to(dt) if a.is_floating_point() else a, tree)


def tree_unflatten(like, leaves: list):
    """``leaves``, in :func:`tree_leaves` order, in ``like``'s structure.
    A module-level recursion: a nested recursive closure would keep itself,
    and through its iterator every leaf, in a reference cycle that only
    the garbage collector frees (a train step's gradients, 4 B a
    parameter, alive into the next step's graph capture)."""
    return _unflatten(like, iter(leaves))


def _unflatten(t, it):
    if isinstance(t, dict):
        return {k: _unflatten(t[k], it) for k in sorted(t)}
    return next(it)


def unstack(tree, n: int) -> list:
    """The ``n`` per-layer views of a layer-stacked tree, by one ``unbind``
    a leaf: under autograd the layers' gradients land in the stacked leaf
    through one stack, where indexing each layer (``a[i]``) would add a
    zero-filled stacked-size gradient a layer."""
    if isinstance(tree, dict):
        parts = {k: unstack(tree[k], n) for k in sorted(tree)}
        return [{k: parts[k][i] for k in parts} for i in range(n)]
    return list(tree.unbind(0))


def stack_layers(n_layers: int, tree):
    """Prepend a layer dim (stacked per-layer params and caches)."""
    return tree_map(
        lambda s: Spec((n_layers,) + s.shape, s.init, s.scale, s.dtype,
                       (None,) + tuple(s.pspec)), tree)


def pspecs(tree):
    """The tree of each leaf's pspec entries (``()`` where it has none)."""
    return tree_map(lambda s: tuple(s.pspec), tree)


def n_params(tree) -> int:
    """The element count of a tree of Specs (or of tensors)."""
    return sum(math.prod(s.shape) for s in tree_leaves(tree))


def abstract(tree, dtype):
    """``meta`` tensors of a Spec tree's shapes (no allocation), each
    leaf in its own dtype or ``dtype``."""
    return tree_map(lambda s: torch.empty(s.shape, dtype=_dtype(s.dtype or dtype),
                                          device="meta"), tree)


def n_bytes(tree) -> int:
    """The bytes of a tree of tensors (``meta`` ones included)."""
    return sum(t.numel() * t.element_size() for t in tree_leaves(tree))


def rank_counts(local_tree, dtype) -> tuple[int, int]:
    """(elements, bytes) a rank holds of a tree of its local Specs
    (``distributed.sharding.local_specs``), each leaf in its own dtype or
    ``dtype``, counted on ``meta`` tensors."""
    return n_params(local_tree), n_bytes(abstract(local_tree, dtype))


# Leaves of more elements are drawn this many at a time (4 GiB of float32 at
# most in flight): arctic-480b's stacked expert leaves hold 8.9e9 elements
# at depth 2, a 35.7 GB float32 draw beside the leaves already drawn.
DRAW_SLICE = 1 << 30


def _dtype(name) -> torch.dtype:
    if isinstance(name, torch.dtype):
        return name
    return getattr(torch, name)


def materialize(tree, generator: torch.Generator, dtype, device):
    """Real tensors for a Spec tree, drawn on ``device`` from ``generator``
    (which must live on that device: 4 B parameters never pass through
    numpy).  ``normal`` leaves draw at ``fan_in ** -0.5`` with the JAX
    package's fan-in rule (``shape[-2]`` for rank >= 2, stacked dim
    included), ``small_normal`` at the leaf's own scale, ``lambda_init``
    as the JAX package's RG-LRU decay parametrization.  A ``normal`` leaf
    of more than :data:`DRAW_SLICE` elements is drawn in slices of that
    many, in row-major order, from the same generator.  The draws differ
    from ``jax.random``'s; parity tests load JAX trees instead."""
    device = torch.device(device)

    def mk(s: Spec):
        dt = _dtype(s.dtype or dtype)
        if s.init == "zeros":
            return torch.zeros(s.shape, dtype=dt, device=device)
        if s.init == "ones":
            return torch.ones(s.shape, dtype=dt, device=device)
        if s.init == "neg_ones":
            return torch.full(s.shape, -1, dtype=dt, device=device)
        if s.init == "lambda_init":
            # RG-LRU Lambda, drawn as the JAX package draws it: u uniform in
            # (0.9, 0.999), lam = -log(expm1(-log u)), so that
            # 1 - exp(-softplus(lam)) = u.
            u = torch.rand(s.shape, generator=generator, dtype=torch.float32,
                           device=device) * (0.999 - 0.9) + 0.9
            return (-torch.log(torch.expm1(-torch.log(u)))).to(dt)
        if s.init not in ("normal", "small_normal"):
            raise ValueError(f"unknown init {s.init!r}")
        scale = s.scale
        if scale is None:
            fan_in = s.shape[-2] if len(s.shape) >= 2 else s.shape[-1]
            scale = fan_in ** -0.5
        n = math.prod(s.shape)
        if n <= DRAW_SLICE:
            x = torch.randn(s.shape, generator=generator, dtype=torch.float32,
                            device=device)
            return x.mul_(scale).to(dt)
        out = torch.empty(s.shape, dtype=dt, device=device)
        flat = out.view(-1)
        for i in range(0, n, DRAW_SLICE):
            m = min(DRAW_SLICE, n - i)
            flat[i:i + m] = torch.randn(m, generator=generator, dtype=torch.float32,
                                        device=device).mul_(scale)
        return out

    return tree_map(mk, tree)


def load_jax_params(np_tree, cfg, device, dtype=torch.float32):
    """The port's parameters from a JAX parameter tree given as numpy
    arrays (``jax.tree_util.tree_map(np.asarray, params)``).

    The port keeps the JAX tree's keys, layer stacking and leaf layouts, so
    the load is a checked leaf-for-leaf copy: every key and shape must match
    the port's own ``param_spec(cfg)``, and floating leaves become ``dtype``
    on ``device``.  The port then computes exactly what the JAX tree
    computes."""
    from repro_torch.models import get_model

    spec = get_model(cfg).param_spec(cfg)

    def check(path, s, a):
        if isinstance(s, dict):
            if not isinstance(a, dict) or set(a) != set(s):
                got = sorted(a) if isinstance(a, dict) else type(a).__name__
                raise ValueError(f"{path or 'params'}: keys {got} != {sorted(s)}")
            for k in s:
                check(f"{path}/{k}", s[k], a[k])
        elif tuple(np.shape(a)) != tuple(s.shape):
            raise ValueError(f"{path}: shape {np.shape(a)} != {s.shape}")

    check("", spec, np_tree)

    def mk(a):
        t = torch.from_numpy(np.array(a))  # a writable copy
        if t.is_floating_point():
            t = t.to(_dtype(dtype))
        return t.to(device)

    return tree_map(mk, np_tree)
