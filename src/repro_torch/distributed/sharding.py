"""Logical-axis sharding, resolved against a :class:`launch.mesh.Mesh`.

Spec leaves carry *logical* entries a dim (None, ``"batch"``, ``"model"``);
the launcher installs the mesh with :func:`set_current_mesh`, and
:func:`named_sharding` resolves entries onto the mesh's axes as the JAX
package does ("batch" -> the "pod" and "data" axes the mesh has, "model"
-> "model" where it exists, an entry whose axes do not divide its dim ->
replicated).  A resolved sharding is a tuple of one entry a dim: None, an
axis name, or a tuple of axis names.

The port computes rank-locally, so a rank holds a sharded leaf as a plain
tensor, its slice (:func:`rank_slice`), and gathers it back with
:func:`gather_leaf`.  :func:`rank_placements` says which leaves the port
holds sharded: every batch-axis entry, and a "model" entry on the leaves
the family's ``model_sliced`` names by whole key path.  Those are every
leaf with a "model" entry -- the reference's tensor parallelism of the
dense leaves, the experts, the seq-sharded cache timeline -- less the few
a family holds whole, each named there with its reason (mamba's
``in_proj``, RG-LRU's ``gate_a``).  A rank computes on its slices with the
collectives GSPMD inserts for the reference, written out: :func:`copy_to`
where a replicated value enters a computation on the rank's slices,
:func:`reduce_from` where the ranks' partial sums become one value,
:func:`gather_from` where their slices become one whole value.  Without a
mesh every function is the identity, so model code is the same on one
rank and on many.
"""
from __future__ import annotations

import dataclasses
import math
import threading
from typing import Any, Optional, Sequence

import torch

_state = threading.local()


def set_current_mesh(mesh) -> None:
    _state.mesh = mesh


def current_mesh():
    """This thread's mesh (None where it installed none)."""
    return getattr(_state, "mesh", None)


def under_mesh(fn, mesh):
    """``fn`` run with ``mesh`` as its thread's current mesh, the thread's
    own restored after: a function that the autograd engine calls again
    on a thread of its own (a remat'd layer's recompute) sees the mesh of
    the forward that captured it."""

    def run(*args, **kwargs):
        prev = current_mesh()
        set_current_mesh(mesh)
        try:
            return fn(*args, **kwargs)
        finally:
            set_current_mesh(prev)

    return run


def batch_axes(mesh=None):
    """Physical axes the global batch is sharded over ("pod" + "data")."""
    mesh = mesh or current_mesh()
    if mesh is None:
        return None
    axes = tuple(a for a in ("pod", "data") if a in mesh.axis_names)
    return axes if axes else None


MODEL = ("model",)


def model_mesh(mesh=None):
    """``mesh`` (the current one by default) when it has a "model" axis of
    more than one rank, else None: the mesh a model rank computes its
    tensor-parallel slices on."""
    mesh = mesh or current_mesh()
    if mesh is not None and mesh.shape.get("model", 1) > 1:
        return mesh
    return None


def model_offset(n_local: int, mesh) -> int:
    """The first index of this model rank's slice of ``n_local`` along a
    dim sliced over "model"."""
    return mesh.coord["model"] * n_local


def shard_map(f, *, mesh, in_specs, out_specs, check_vma: bool = False):
    """The reference's ``shard_map``: ``f`` on each rank's slices.  A rank
    of the port already holds its slices and calls ``f`` on them, so this
    is ``f`` itself."""
    return f


def _normalize(axes):
    """Canonical entry: a 1-tuple becomes the bare axis name."""
    if isinstance(axes, tuple) and len(axes) == 1:
        return axes[0]
    return axes


def _resolve(entry: Any, mesh) -> Any:
    """A logical entry's mesh axes (or None)."""
    if entry is None:
        return None
    if entry == "batch":
        return _normalize(batch_axes(mesh))
    if entry == "model":
        return "model" if "model" in mesh.axis_names else None
    if isinstance(entry, tuple):
        out = []
        for e in entry:
            r = _resolve(e, mesh)
            if isinstance(r, tuple):
                out.extend(r)
            elif r is not None:
                out.append(r)
        return _normalize(tuple(out)) if out else None
    return entry if entry in mesh.axis_names else None


def resolve_pspec(entries: tuple) -> tuple:
    """``entries`` resolved against the current mesh (``()`` without one)."""
    mesh = current_mesh()
    if mesh is None:
        return ()
    return tuple(_resolve(e, mesh) for e in entries)


def shard(x, *entries):
    """The reference's sharding constraint by logical axes.  It changes no
    value, and a rank-local tensor is already where it belongs: ``x``."""
    return x


@dataclasses.dataclass(frozen=True)
class Parts:
    """A placement entry of the port's own: a dim of ``parts`` equal
    blocks, each sliced over ``axes``, the rank holding its slice of every
    block in block order (mamba's ``in_proj``, whose columns are x then
    z).  Its local shape is the contiguous slice's; gathered, the blocks
    come back in the reference's order."""
    axes: tuple
    parts: int


def axes_of(resolved) -> tuple:
    """A resolved entry as a tuple of axis names (``()`` for None)."""
    if resolved is None:
        return ()
    if isinstance(resolved, Parts):
        return resolved.axes
    return resolved if isinstance(resolved, tuple) else (resolved,)


def _axes_size(mesh, resolved) -> int:
    return math.prod(mesh.shape[a] for a in axes_of(resolved))


def named_sharding(mesh, entries: tuple, shape: Optional[tuple] = None) -> tuple:
    """``entries`` resolved against ``mesh``: one entry a dim.  With
    ``shape``, an entry whose axes' product does not divide its dim is
    dropped (e.g. 8 kv heads on a 16-way model axis): replicated instead
    of failing."""
    resolved = [_resolve(e, mesh) for e in entries]
    if shape is not None:
        for i, r in enumerate(resolved):
            if r is not None and i < len(shape) and shape[i] % _axes_size(mesh, r) != 0:
                resolved[i] = None
    return tuple(resolved)


def spec_tree_shardings(spec_tree, mesh):
    """Spec tree -> tree of resolved shardings."""
    from repro_torch.models.params import tree_map

    return tree_map(lambda s: named_sharding(mesh, tuple(s.pspec), s.shape), spec_tree)


def entry_tree_shardings(entry_tree, mesh, abstract_tree=None):
    """Tree of logical entry tuples -> tree of resolved shardings;
    ``abstract_tree`` (a matching tree of shaped leaves) makes the
    resolution divisibility-aware."""
    if isinstance(entry_tree, dict):
        return {k: entry_tree_shardings(entry_tree[k], mesh,
                                        None if abstract_tree is None else abstract_tree[k])
                for k in sorted(entry_tree)}
    shape = None if abstract_tree is None else tuple(abstract_tree.shape)
    return named_sharding(mesh, tuple(entry_tree), shape)


def maybe_axis(logical: str, dim_size: int, par: int) -> Optional[str]:
    """Use a sharded axis only when the dim divides evenly (e.g. 56 heads
    on a 16-way model axis do NOT shard; head_dim 128 does)."""
    return logical if par > 0 and dim_size % max(par, 1) == 0 and par > 1 else None


# ------------------------------------------------------------ the rank's slices


def placements(spec_tree, mesh, held: Sequence[str] = (), parts=None):
    """The port's placement of each leaf of ``spec_tree`` on ``mesh``: the
    reference's resolved sharding, less the "model" axis except on the
    leaves whose whole key path is in ``held`` (``layers/experts/w_up``
    ...); a path of ``held`` that is not a leaf of the tree raises.
    ``parts`` (path -> blocks): those leaves' "model" dim takes the
    :class:`Parts` layout.  Without a mesh, every leaf whole."""
    from repro_torch.models.params import tree_map_path

    held, parts = frozenset(held), dict(parts or {})
    seen = set()

    def place(path, s):
        if mesh is None:
            return (None,) * len(s.shape)
        res = named_sharding(mesh, tuple(s.pspec), s.shape)
        res = res + (None,) * (len(s.shape) - len(res))
        if path in held:
            seen.add(path)
            if path in parts:
                res = tuple(Parts(axes_of(r), parts[path]) if "model" in axes_of(r) else r
                            for r in res)
            return res
        return tuple(_normalize(tuple(a for a in axes_of(r) if a != "model")) or None
                     for r in res)

    out = tree_map_path(place, spec_tree)
    if mesh is not None and held - seen:
        raise ValueError(f"no leaf at {sorted(held - seen)} to slice over 'model'")
    return out


def model_paths(spec_tree) -> tuple:
    """The whole key paths of the leaves of ``spec_tree`` with a "model"
    entry (alone or in a tuple of axes), in sorted order."""
    from repro_torch.models.params import tree_leaves, tree_map_path

    def has(path, s):
        return path if any(e == "model" or (isinstance(e, tuple) and "model" in e)
                           for e in s.pspec) else None

    return tuple(p for p in tree_leaves(tree_map_path(has, spec_tree)) if p is not None)


def rank_placements(cfg, spec_tree, mesh, tree: str):
    """(placements, the rank's Spec tree) of ``spec_tree``, a ``tree`` of
    kind "params" (the family's ``param_spec``), "cache" (its
    ``cache_spec``) or "state" (``train.step.state_spec``'s), on ``mesh``:
    the leaves the family's ``model_sliced`` names sliced over "model" (in
    a state, the parameter and its m and v; ``parts`` in their layout),
    the "model" entries of the leaves it holds whole dropped, and the
    batch entries sliced."""
    if tree not in ("params", "cache", "state"):
        raise ValueError(f"tree {tree!r} is not params, cache or state")
    held, parts = (), {}
    if mesh is not None:
        from repro_torch.models import get_model

        sliced = get_model(cfg).model_sliced(cfg, mesh)
        if tree == "cache":
            held = sliced["cache"]
        elif tree == "params":
            held, parts = sliced["params"], sliced.get("parts", {})
        else:
            pre = ("params", "opt/m", "opt/v")
            held = tuple(f"{a}/{p}" for a in pre for p in sliced["params"])
            parts = {f"{a}/{p}": k for a in pre for p, k in sliced.get("parts", {}).items()}
    pl = placements(spec_tree, mesh, held, parts)
    return pl, local_specs(spec_tree, pl, mesh)


def local_shape(shape: Sequence[int], sharding: tuple, mesh) -> tuple:
    """A leaf's shape on one rank."""
    out = []
    for i, n in enumerate(shape):
        r = sharding[i] if i < len(sharding) else None
        k = 1 if mesh is None or r is None else _axes_size(mesh, r)
        if n % k:
            raise ValueError(f"dim {i} of {tuple(shape)} does not split over {r} ({k})")
        out.append(n // k)
    return tuple(out)


def local_specs(spec_tree, shardings, mesh):
    """``spec_tree`` with every leaf's shape cut to the rank's slice."""
    import dataclasses

    from repro_torch.models.params import tree_map

    return tree_map(lambda s, sh: dataclasses.replace(s, shape=local_shape(s.shape, sh, mesh)),
                    spec_tree, shardings)


def rank_slice(x: torch.Tensor, sharding: tuple, mesh) -> torch.Tensor:
    """The rank's slice of a whole leaf ``x`` (a view, or a copy where a
    :class:`Parts` dim joins its blocks' slices)."""
    if mesh is None:
        return x
    for i, r in enumerate(sharding):
        if r is None:
            continue
        axes = axes_of(r)
        k = r.parts if isinstance(r, Parts) else 1
        n = x.shape[i] // k
        m = n // mesh.size(axes)
        blocks = [x.narrow(i, b * n + mesh.index(axes) * m, m) for b in range(k)]
        x = blocks[0] if k == 1 else torch.cat(blocks, dim=i)
    return x


def gather_leaf(x: torch.Tensor, sharding: tuple, mesh) -> torch.Tensor:
    """The whole leaf from every rank's slice ``x``: ``all_gather`` over
    each sharded dim's axes, in the mesh's index order."""
    if mesh is None:
        return x
    for i, r in enumerate(sharding):
        if r is None:
            continue
        n = x.shape[i]
        x = mesh.all_gather(x, axes_of(r), dim=i)
        if isinstance(r, Parts):  # (ranks, blocks, m) -> (blocks, ranks, m)
            ranks, m = mesh.size(r.axes), n // r.parts
            shape = x.shape[:i] + (ranks, r.parts, m) + x.shape[i + 1:]
            x = x.reshape(shape).transpose(i, i + 1).reshape(x.shape)
    return x


def shard_tree(tree, shardings, mesh):
    """The rank's slices of a tree of whole leaves: a copy of the slice of
    each sharded leaf, the leaf itself where it is whole."""
    from repro_torch.models.params import tree_map

    def cut(x, sh):
        if mesh is None or all(r is None for r in sh):
            return x
        return rank_slice(x, sh, mesh).clone()

    return tree_map(cut, tree, shardings)


def gather_tree(tree, shardings, mesh):
    """The whole leaves of a tree of rank slices (every rank gets them)."""
    from repro_torch.models.params import tree_map

    return tree_map(lambda x, sh: gather_leaf(x, sh, mesh), tree, shardings)


# ------------------------------------------------- collectives under autograd


class _ReduceFrom(torch.autograd.Function):
    """``all_reduce`` SUM forward; the cotangent passes through unchanged.
    The transpose of a sum that every rank of the group holds and computes
    on identically (one objective, not one a rank)."""

    @staticmethod
    def forward(ctx, x, mesh, axes):
        return mesh.all_reduce(x.clone(), axes, "sum")

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _CopyTo(torch.autograd.Function):
    """The identity forward; ``all_reduce`` SUM of the cotangents backward:
    a replicated input whose ranks each use it for their part of one sum."""

    @staticmethod
    def forward(ctx, x, mesh, axes):
        ctx.mesh, ctx.axes = mesh, axes
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.mesh.all_reduce(g.clone(), ctx.axes, "sum"), None, None


class _GatherFrom(torch.autograd.Function):
    """``all_gather`` along ``dim`` forward; backward, the rank's own slice
    of the cotangent: the gathered value is replicated, every rank computes
    on it identically and holds its whole cotangent."""

    @staticmethod
    def forward(ctx, x, mesh, axes, dim):
        ctx.mesh, ctx.axes, ctx.dim, ctx.n = mesh, axes, dim, x.shape[dim]
        return mesh.all_gather(x, axes, dim)

    @staticmethod
    def backward(ctx, g):
        lo = ctx.mesh.index(ctx.axes) * ctx.n
        return g.narrow(ctx.dim, lo, ctx.n), None, None, None


def gather_from(x: torch.Tensor, mesh, axes, dim: int) -> torch.Tensor:
    """The group's slices of ``x`` concatenated along ``dim``, on every
    rank (a replicated value); its gradient is the rank's slice of the
    cotangent."""
    if mesh is None or mesh.size(axes) == 1:
        return x
    if not (torch.is_grad_enabled() and x.requires_grad):
        return mesh.all_gather(x, tuple(axes), dim)
    return _GatherFrom.apply(x, mesh, tuple(axes), dim)


def reduce_from(x: torch.Tensor, mesh, axes) -> torch.Tensor:
    """The group's sum of ``x``, on every rank; its gradient is each
    rank's own cotangent (torch.distributed's collectives carry none)."""
    if mesh is None or mesh.size(axes) == 1:
        return x
    return _ReduceFrom.apply(x, mesh, tuple(axes))


def copy_to(x: torch.Tensor, mesh, axes) -> torch.Tensor:
    """``x`` itself; its gradient is the group's sum of the cotangents."""
    if mesh is None or mesh.size(axes) == 1 or not torch.is_grad_enabled():
        return x
    return _CopyTo.apply(x, mesh, tuple(axes))
