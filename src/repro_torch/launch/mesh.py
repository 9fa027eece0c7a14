"""Device meshes over a ``torch.distributed`` world.

The port's mesh is rank-local SPMD, the counterpart of ``shard_map``'s
local view: each process is one rank, a sharded leaf is a plain tensor
holding the rank's slice (so the port's kernels run on it unchanged), and
the reference's collectives are ``all_reduce`` (SUM, MAX) and
``all_gather`` on the mesh's axis groups (:class:`Mesh`).  No broadcast is
needed: every rank draws the same state from a seed or loads the same
checkpoint.

The backend is chosen by the world's devices, node by node, never by
trying one (:func:`backend_for`): NCCL when every rank of a node has a
card of its own, gloo when one node's ranks share its card or run on the
CPU.  NCCL refuses two ranks of one communicator on one GPU, and gloo
carries CUDA tensors itself (it copies them through host memory inside
each collective), so on one H100 the ranks compute on cuda:0 and exchange
over gloo.

While a CUDA graph of a mesh step is being recorded (``serve/graphs.py``),
the stream it captures on has a segmented recording open
(:func:`recording_on`): a collective issued on that stream is not run but
closes the recording's current graph, is kept as a node that issues it
on the tensors the capture saw, and the next graph begins.  A replay runs
the graphs and the nodes in turn, each node counted in ``Mesh.stats`` as
the eager step counts its collective.

``make_production_mesh`` is a function, not a module constant, so that
importing this module touches no process group.
"""
from __future__ import annotations

import math
import os
import tempfile
from pathlib import Path
from typing import Callable, Sequence

import torch
import torch.distributed as dist

PRODUCTION_SHAPES = {False: ((16, 16), ("data", "model")),
                     True: ((2, 16, 16), ("pod", "data", "model"))}
COLLECTIVES = ("all_reduce", "all_gather")
# The segmented recordings open now (``serve/graphs.Segments``), by the
# raw handle of the stream each one captures on (None for an emulated
# recording of CPU tensors).
RECORDINGS: dict = {}


def stream_key(device):
    """The key of ``device``'s current stream in :data:`RECORDINGS`."""
    return torch.cuda.current_stream(device).cuda_stream if device.type == "cuda" else None


def recording_on(device):
    """The segmented recording open on ``device``'s current stream, or
    None: on the thread that began it, and on the autograd engine's thread
    while it runs a backward captured there, whose current stream is the
    forward's."""
    if not RECORDINGS:
        return None
    return RECORDINGS.get(stream_key(device))


class Collective:
    """One collective of a mesh on fixed tensors: an ``all_reduce`` of
    ``tensor`` in place, or an ``all_gather`` of ``tensor`` into
    ``parts``, over ``group`` with ``op``.  Calling it issues it and
    counts it in the mesh's ``stats``; a segmented recording keeps it as
    a node, called at every replay."""

    __slots__ = ("mesh", "kind", "group", "op", "tensor", "parts")

    def __init__(self, mesh, kind: str, group, tensor: torch.Tensor, op=None,
                 parts=None) -> None:
        self.mesh, self.kind, self.group, self.op = mesh, kind, group, op
        self.tensor, self.parts = tensor, parts

    def __call__(self) -> None:
        self.mesh._count(self.kind, self.tensor)
        if self.kind == "all_reduce":
            dist.all_reduce(self.tensor, op=self.op, group=self.group)
        else:
            dist.all_gather(self.parts, self.tensor, group=self.group)


def _issue(collective: Collective) -> None:
    """Issue ``collective`` now, or, under a recording open on its
    tensor's device's current stream, make it a node of the recording
    between two graphs."""
    rec = recording_on(collective.tensor.device)
    if rec is None:
        collective()
    else:
        rec.boundary(collective)


def _local_world(world: int) -> int:
    """The ranks of this world on this node: ``LOCAL_WORLD_SIZE`` under
    torchrun (at most ``world``, which an elastic rebuild may have cut),
    else ``world`` (one node, as ``spawn_world`` starts it)."""
    return min(int(os.environ.get("LOCAL_WORLD_SIZE", world)), world)


def backend_for(device, world: int) -> str:
    """The backend of a world of ``world`` ranks computing on ``device``,
    decided per node: ``nccl`` when the ranks compute on CUDA and each rank
    of a node has a card of its own (the node's ranks, ``LOCAL_WORLD_SIZE``
    under torchrun, at most its visible cards); ``gloo`` when the ranks run
    on the CPU, or when one node's ranks outnumber its cards and share them
    (NCCL refuses two ranks of one communicator on one GPU).  A world of
    several nodes whose ranks would share cards raises: gloo would carry
    every collective through the hosts across nodes."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return "gloo"
    local = _local_world(world)
    if local <= torch.cuda.device_count():
        return "nccl"
    if local < world:
        raise ValueError(f"{local} ranks a node share {torch.cuda.device_count()} card(s) "
                         f"in a world of {world} ranks over several nodes: give each rank "
                         f"a card of its own")
    return "gloo"


def rank_device(device, world: int, rank: int) -> torch.device:
    """The device rank ``rank`` computes on: under NCCL its own card, the
    node-local rank's (``LOCAL_RANK`` under torchrun, else ``rank``); cuda:0
    for every rank that shares a node's one card; or the CPU."""
    from repro_torch import resolve_device

    dev = resolve_device(torch.device(device).type)
    if dev.type == "cuda":
        local = int(os.environ.get("LOCAL_RANK", rank))
        idx = local if backend_for(dev, world) == "nccl" else 0
        torch.cuda.set_device(idx)
        return torch.device("cuda", idx)
    return dev


def init_world(rank: int, world: int, device, init_method: str) -> torch.device:
    """Join a world of ``world`` ranks as ``rank`` through ``init_method``
    (``file://...`` or ``tcp://localhost:<port>``) on the backend
    :func:`backend_for` names; returns the rank's device.  A rank on
    ``cuda`` raises without a card, as every entry point does."""
    dev = rank_device(device, world, rank)
    backend = backend_for(dev, world)
    dist.init_process_group(backend, init_method=init_method, rank=rank, world_size=world,
                            device_id=dev if backend == "nccl" else None)
    return dev


class Mesh:
    """A named mesh over the initialised world, row-major over the global
    ranks: the reference's ``axis_names`` and ``shape`` (axis -> size), the
    rank's ``coord`` (axis -> index), the ``device`` it computes on, and
    the ``torch.distributed.device_mesh.DeviceMesh`` that holds a process
    group per axis.  The batch axes ("pod" and "data" together) get one
    more group.  ``stats`` counts the collectives issued through the mesh
    and their bytes, by kind."""

    def __init__(self, shape: Sequence[int], axes: Sequence[str], device) -> None:
        from torch.distributed.device_mesh import DeviceMesh

        world = dist.get_world_size()
        if math.prod(shape) != world:
            raise ValueError(f"mesh {tuple(shape)} over {tuple(axes)} needs "
                             f"{math.prod(shape)} ranks; the world has {world}")
        self.axis_names = tuple(axes)
        self.shape = dict(zip(self.axis_names, (int(n) for n in shape)))
        self.device = torch.device(device)
        ranks = torch.arange(world).reshape(tuple(shape))
        # The DeviceMesh's device type is the backend's: gloo's groups take
        # the CUDA tensors of ranks that share a card.
        kind = "cuda" if dist.get_backend() == "nccl" else "cpu"
        self.device_mesh = DeviceMesh(kind, ranks, mesh_dim_names=self.axis_names)
        coord = self.device_mesh.get_coordinate()
        self.coord = dict(zip(self.axis_names, coord))
        self._groups = {(a,): self.device_mesh.get_group(a) for a in self.axis_names}
        batch = tuple(a for a in ("pod", "data") if a in self.axis_names)
        if len(batch) > 1:
            # One group per index of the other axes, every rank creating
            # every group in the same order, as new_group requires.
            dims = [self.axis_names.index(a) for a in batch]
            moved = ranks.movedim(dims, list(range(len(dims)))).reshape(
                math.prod(self.shape[a] for a in batch), -1)
            for col in moved.T.tolist():
                g = dist.new_group(sorted(col))
                if dist.get_rank() in col:
                    self._groups[batch] = g
        self.stats = {k: [0, 0] for k in COLLECTIVES}

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, device={self.device}, coord={self.coord})"

    def size(self, axes: Sequence[str]) -> int:
        return math.prod(self.shape[a] for a in axes)

    def index(self, axes: Sequence[str]) -> int:
        """The rank's index along ``axes`` taken together (mixed radix in
        the mesh's order: the position of its slice of a dim sharded over
        them)."""
        i = 0
        for a in axes:
            i = i * self.shape[a] + self.coord[a]
        return i

    def group(self, axes: Sequence[str]):
        axes = tuple(axes)
        if axes not in self._groups:
            raise ValueError(f"the mesh has no group over {axes}: it has one a single "
                             f"axis and one over the batch axes")
        return self._groups[axes]

    def _count(self, kind: str, t: torch.Tensor) -> None:
        self.stats[kind][0] += 1
        self.stats[kind][1] += t.numel() * t.element_size()

    def all_reduce(self, t: torch.Tensor, axes: Sequence[str], op: str = "sum") -> torch.Tensor:
        """In place over the group of ``axes``; ``op`` is ``sum`` or
        ``max``.  A group of one rank issues nothing.  Under a segmented
        recording, a node between two graphs (:func:`recording_on`)."""
        if self.size(axes) > 1:
            red = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}[op]
            _issue(Collective(self, "all_reduce", self.group(axes), t, op=red))
        return t

    def all_gather(self, t: torch.Tensor, axes: Sequence[str], dim: int) -> torch.Tensor:
        """The group's slices of ``t`` concatenated along ``dim``, in the
        group's index order.  Under a segmented recording the gather is a
        node into ``parts`` made once, and the concatenation opens the
        next graph."""
        n = self.size(axes)
        if n == 1:
            return t
        t = t.contiguous()
        parts = [torch.empty_like(t) for _ in range(n)]
        _issue(Collective(self, "all_gather", self.group(axes), t, parts=parts))
        return torch.cat(parts, dim=dim)

    def reset_stats(self) -> dict:
        """The counts so far, then zero them."""
        out = {k: tuple(v) for k, v in self.stats.items()}
        self.stats = {k: [0, 0] for k in COLLECTIVES}
        return out


def make_mesh(shape, axes, device="cuda") -> Mesh:
    """A mesh of ``shape`` named ``axes`` over the initialised world,
    computing on ``device`` (``cuda`` unless the CPU is asked for: it
    raises without a card, as every entry point does; a rank's own card is
    what ``init_world`` returned).  Raises when the world's size is not
    the product of ``shape``."""
    from repro_torch import resolve_device

    device = torch.device(device)
    resolve_device(device.type)
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs an initialised torch.distributed world "
                           "(launch.mesh.init_world or spawn_world)")
    return Mesh(shape, axes, device)


class AbstractMesh:
    """A mesh's shape and axis names with no world behind it, seen from
    one rank (``coord``, rank 0 by default): what placements, local
    shapes and rank slices read.  It issues no collective."""

    def __init__(self, shape: Sequence[int], axes: Sequence[str], coord=None) -> None:
        self.axis_names = tuple(axes)
        self.shape = dict(zip(self.axis_names, (int(n) for n in shape)))
        self.coord = dict(zip(self.axis_names, coord or (0,) * len(self.axis_names)))

    def __repr__(self) -> str:
        return f"AbstractMesh({self.shape})"

    @property
    def n_ranks(self) -> int:
        return math.prod(self.shape.values())

    def size(self, axes: Sequence[str]) -> int:
        return math.prod(self.shape[a] for a in axes)

    index = Mesh.index


def abstract_production_mesh(*, multi_pod: bool = False) -> AbstractMesh:
    """The production mesh's shape and axis names, (16, 16) ("data",
    "model") or (2, 16, 16) ("pod", "data", "model"), with no world: the
    dry-run resolves placements on it."""
    shape, axes = PRODUCTION_SHAPES[multi_pod]
    return AbstractMesh(shape, axes)


def make_production_mesh(*, multi_pod: bool = False, device="cuda") -> Mesh:
    """16x16 ("data", "model") = 256 ranks; 2x16x16 ("pod", "data",
    "model") = 512.  Raises, naming the ranks it needs, on another world."""
    shape, axes = PRODUCTION_SHAPES[multi_pod]
    need = math.prod(shape)
    world = dist.get_world_size() if dist.is_initialized() else 1
    if world != need:
        raise ValueError(f"the {'multipod' if multi_pod else 'pod'} mesh {shape} needs "
                         f"a world of {need} ranks; this one has {world}")
    return make_mesh(shape, axes, device)


def model_par(mesh) -> int:
    """Model-axis degree (1 without a mesh or a "model" axis)."""
    if mesh is None or "model" not in mesh.axis_names:
        return 1
    return mesh.shape["model"]


def data_par(mesh) -> int:
    """The batch axes' degree ("pod" x "data")."""
    if mesh is None:
        return 1
    n = 1
    for a in ("pod", "data"):
        if a in mesh.axis_names:
            n *= mesh.shape[a]
    return n


def _rank_entry(rank: int, fn: Callable, world: int, device, init_method: str,
                out: str, args: tuple) -> None:
    # A rank still in a world leaves it after a barrier: gloo aborts a
    # process whose peer tears the pairs down while the last collective's
    # messages are still in flight.  A rank that left (a lost rank of an
    # elastic test) or whose world was rebuilt runs no collective here.
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
    dev = init_world(rank, world, device, init_method)
    try:
        result = fn(rank, world, dev, *args)
        torch.save(result, f"{out}.{rank}")
    finally:
        if dist.is_initialized():
            dist.barrier()
            dist.destroy_process_group()


def spawn_world(fn: Callable, world: int, device, init_file, args: tuple = ()) -> list:
    """Run ``fn(rank, world, device, *args)`` in ``world`` spawned
    processes joined through the ``file://`` store ``init_file`` (a path
    that must not exist yet), and return the ranks' results in rank order
    (each ``torch.save``-d by its rank beside the store).  ``fn`` must be a
    module-level function; the children import its module, and nothing of
    the parent's state.  A rank's exception is raised here.  A rank that
    leaves the world early (``destroy_process_group`` in ``fn``, as a lost
    rank does) takes no part in the closing barrier."""
    import torch.multiprocessing as mp

    init_file = Path(init_file)
    if init_file.exists():
        raise FileExistsError(f"{init_file}: the store of another world")
    out = str(init_file) + ".out"
    mp.spawn(_rank_entry, args=(fn, world, str(device), f"file://{init_file}", out, args),
             nprocs=world, join=True)
    results = [torch.load(f"{out}.{r}", weights_only=False) for r in range(world)]
    for r in range(world):
        os.remove(f"{out}.{r}")
    return results


def fresh_store(root=None) -> Path:
    """A path for a new ``file://`` store under ``root`` (a new temporary
    directory by default)."""
    d = Path(tempfile.mkdtemp(dir=root))
    return d / "store"
