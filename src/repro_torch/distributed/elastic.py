"""Elastic management: survive the loss of ranks (training) or of groups
(serving) without operator action.

Port of the JAX package's ``distributed/elastic.py``.  Training: on a
failure :class:`ElasticRunner` (1) plans the largest valid mesh for the
surviving ranks (:func:`plan_remesh`, pure logic), (2) rebuilds the world
over them -- a new process group of the survivors, or a world of one --
and the mesh on it, (3) restores the latest checkpoint with the new
mesh's shardings (``restore_checkpoint`` takes each rank's slice), and
(4) rebuilds the train step.  Serving: :class:`ElasticServeGroups` lets a
DeviceGroup join a live server or drain from it (its decode slots migrate
to the surviving groups at segment boundaries) without dropping a
request.  On one card the groups are CUDA streams of it.
"""
from __future__ import annotations

import dataclasses
import gc
from typing import Callable, Sequence

import torch


@dataclasses.dataclass(frozen=True)
class MeshPlan:
    shape: tuple
    axes: tuple
    n_devices: int


def plan_remesh(n_devices: int, *, model_par: int, prefer_pods: bool = True) -> MeshPlan:
    """Largest mesh covering <= n_devices with a fixed model axis.

    Keeps `model` (tensor-parallel degree is a property of the model
    sharding, not the fleet) and gives the rest to data/pod axes -- dropping
    stragglers beyond the largest power-of-two data extent.
    """
    if n_devices < model_par:
        raise ValueError(f"{n_devices} devices cannot host model_par={model_par}")
    data_total = n_devices // model_par
    # Largest power-of-two data extent (collectives want powers of two).
    data = 1 << (data_total.bit_length() - 1)
    if prefer_pods and data >= 2:
        return MeshPlan((2, data // 2, model_par), ("pod", "data", "model"),
                        2 * (data // 2) * model_par)
    return MeshPlan((data, model_par), ("data", "model"), data * model_par)


class ElasticRunner:
    """Builds (mesh, state, step_fn) on the current world and rebuilds them
    on the survivors after a failure.  ``state_spec_fn(cfg, plan)`` gives
    the state's Spec tree for a :class:`MeshPlan`, ``step_factory(cfg,
    api)`` the train step (made under the new mesh: on the card it replays
    CUDA graphs, as the reference jits it); the ranks compute on
    ``device``: ``cuda`` unless the CPU is asked for, raising without a
    card, as every entry point does.  A rebuild first drops the old step
    function, with its graphs and their memory pool, and the old state,
    and returns the card's cached blocks."""

    def __init__(self, cfg, api, *, state_spec_fn: Callable, step_factory: Callable,
                 ckpt_dir: str, model_par: int, device="cuda") -> None:
        from repro_torch import resolve_device

        self.cfg = cfg
        self.api = api
        self.state_spec_fn = state_spec_fn
        self.step_factory = step_factory
        self.ckpt_dir = ckpt_dir
        self.model_par = model_par
        self.device = torch.device(device)
        resolve_device(self.device.type)
        self.mesh = None
        self.shardings = None
        self.state = None
        self.step_fn = None

    def build(self):
        """(Re)build the mesh on the initialised world and restore the
        latest checkpoint onto it: returns (mesh, state, the checkpoint's
        ``extra``)."""
        import torch.distributed as dist

        from repro_torch.ckpt import latest_step, restore_checkpoint
        from repro_torch.distributed.sharding import rank_placements, set_current_mesh
        from repro_torch.launch.mesh import make_mesh
        from repro_torch.models.params import tree_map

        self.release()
        world = dist.get_world_size()
        plan = plan_remesh(world, model_par=min(self.model_par, world))
        if plan.n_devices != world:
            raise ValueError(f"a world of {world} ranks is not a mesh; plan {plan}")
        self.mesh = make_mesh(plan.shape, plan.axes, self.device)
        set_current_mesh(self.mesh)
        sspec = self.state_spec_fn(self.cfg, plan)
        self.shardings, local = rank_placements(self.cfg, sspec, self.mesh, "state")
        step = latest_step(self.ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no checkpoint in {self.ckpt_dir}")
        like = tree_map(lambda s: torch.empty(
            s.shape, dtype=getattr(torch, s.dtype or self.cfg.param_dtype), device="meta"),
            local)
        self.state, extra = restore_checkpoint(self.ckpt_dir, step, like, self.shardings,
                                               self.mesh)
        self.step_fn = self.step_factory(self.cfg, self.api)
        return self.mesh, self.state, extra

    def release(self) -> None:
        """Drop the step function (its ``GraphCache``: the graphs, their
        private pool, the collectives' nodes on the old world's groups) and
        the state, and on the card return the allocator's cached blocks."""
        self.step_fn = self.state = None
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def on_failure(self, survivors: Sequence[int], init_method: str):
        """Ranks were lost: this process's world is rebuilt over the
        ``survivors`` (global ranks of the old world, this one among them)
        that :func:`plan_remesh` keeps, as a new process group joined
        through ``init_method`` (a store the old world never used), and
        :meth:`build` runs on it.  A survivor the plan leaves out returns
        None and takes no further part."""
        import torch.distributed as dist

        from repro_torch.distributed.sharding import set_current_mesh
        from repro_torch.launch.mesh import init_world

        me = dist.get_rank() if dist.is_initialized() else 0
        self.release()
        if dist.is_initialized():
            dist.destroy_process_group()
        set_current_mesh(None)
        plan = plan_remesh(len(survivors), model_par=min(self.model_par, len(survivors)))
        members = sorted(survivors)[:plan.n_devices]
        if me not in members:
            return None
        self.device = init_world(members.index(me), len(members), self.device, init_method)
        return self.build()


class ElasticServeGroups:
    """Elastic group management for a live ``InferenceServer``.

    The serving analogue of :class:`ElasticRunner`: instead of rebuilding a
    mesh from survivors and restoring a checkpoint, the server's
    ``group_batches`` regime lets a DeviceGroup *join* (fresh per-group
    block pool, immediately eligible for wave placement) or *drain* (its
    decode slots migrate to surviving groups at segment boundaries) without
    dropping in-flight requests — host mirrors are authoritative at
    boundaries, so no checkpoint round-trip is needed.
    """

    def __init__(self, server) -> None:
        self.server = server

    def join(self, group) -> None:
        """Scale up: add ``group`` to the live server (or un-drain it)."""
        self.server.join_group(group)

    def drain(self, name: str) -> None:
        """Scale down: stop placing work on ``name``; active slots migrate
        off at their next segment boundary and the member dissolves."""
        self.server.drain_group(name)

    def on_failure(self, lost_name: str) -> None:
        """Pod is going away: drain it so in-flight decode state moves to
        the survivors through the O(blocks) migration path."""
        self.server.drain_group(lost_name)
