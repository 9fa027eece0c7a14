"""Training launcher: config -> data -> train step -> checkpoint/restart.

    # on the card, full widths (whisper-tiny trains whole on one H100)
    PYTHONPATH=src python -m repro_torch.launch.train --arch whisper-tiny --full \\
        --steps 4 --batch 8 --seq 64 --ckpt /tmp/ck --ckpt-interval 2
    PYTHONPATH=src python -m repro_torch.launch.train --arch whisper-tiny --full \\
        --steps 6 --batch 8 --seq 64 --ckpt /tmp/ck --restore

    # on the CPU, reduced config
    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen1.5-4b --device cpu

    # a data-parallel world of 2 ranks on the CPU, and a tensor-parallel one
    PYTHONPATH=src torchrun --nproc-per-node 2 -m repro_torch.launch.train \
        --arch qwen1.5-4b --device cpu --mesh-shape 2x1
    PYTHONPATH=src torchrun --nproc-per-node 2 -m repro_torch.launch.train \
        --arch qwen1.5-4b --device cpu --mesh-shape 1x2

The JAX launcher's flags, plus ``--kernel`` (``cfg.kernel_impl``: ``cuda``
runs every Sq > 1 attention on the ``flash_attention`` kernel through its
autograd Function; the rest of the train step is the reference's
computations either way), ``--device`` (``cuda`` unless ``cpu`` is asked
for; raises without a card) and ``--mesh-shape DxM`` (a ("data", "model")
mesh of any size).  ``--mesh pod`` / ``multipod`` is the production mesh of
256 / 512 ranks and raises on another world.  A mesh runs on the world
this process is in: one started by ``torchrun`` (``env://``), one that the
caller initialised (``launch.mesh.spawn_world``), or else a world of one.
The state (float32 parameters, AdamW's m and v, the step) is drawn from
``--seed`` on the device, and each rank keeps its slices of it (m and v
under ZeRO-1; over a model axis of M > 1, every leaf the reference slices
over "model", which the rank then computes on: tensor parallelism);
batches are
``SyntheticTokens(seed=--seed)`` of the global batch, each rank's rows
prefetched onto its device (``ShardedLoader``).  ``--restore`` resumes
from the latest checkpoint under ``--ckpt``, the data cursor from its
manifest; under a mesh the first rank writes the checkpoints and prints.

The step is ``make_train_step``'s, the JAX launcher's ``jax.jit(...,
donate_argnums=(0,))``: on the card, run eagerly at its first step,
recorded after it and replayed for every later one, the state updated in
place: one CUDA graph without a mesh, and under a mesh one graph per
stretch between two of its collectives, the collectives issued between
the replays (``serve/graphs.Segments``); on the CPU, eager.  The first
line printed says which.
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import time

import torch
import torch.distributed as dist

from repro_torch import resolve_device
from repro_torch.ckpt import CheckpointManager, latest_step, restore_checkpoint
from repro_torch.configs import ShapeCell, get_config, reduced
from repro_torch.data import ShardedLoader, SyntheticTokens
from repro_torch.distributed.sharding import global_batch, set_current_mesh, shard_tree
from repro_torch.launch.mesh import (fresh_store, init_world, make_mesh,
                                     make_production_mesh, rank_device)
from repro_torch.launch.specs import input_specs
from repro_torch.models import KERNEL_IMPLS, get_model
from repro_torch.models.params import materialize, n_params  # noqa: F401
from repro_torch.train import make_train_step, state_spec
from repro_torch.train.step import state_placements


def build_state(cfg, api, device, seed: int, mesh=None):
    """(state, its Spec tree): float32 masters and zero m, v and step,
    drawn on ``device`` from ``seed``.  Under a ``mesh`` every rank draws
    the same whole state and keeps its slices (``state_placements``)."""
    if mesh is None:
        sspec, places = state_spec(cfg, api.param_spec(cfg)), None
    else:
        sspec, places = state_placements(cfg, api, mesh)
    gen = torch.Generator(device=device).manual_seed(seed)
    state = materialize(sspec, gen, torch.float32, device)
    return (shard_tree(state, places, mesh) if mesh is not None else state), sspec


def build_mesh(args, device):
    """The mesh ``--mesh`` / ``--mesh-shape`` ask for (None for neither)
    and the rank's device, on the world this process is in."""
    if args.mesh == "none" and not args.mesh_shape:
        return None, device
    if args.mesh != "none" and not dist.is_initialized() and "WORLD_SIZE" not in os.environ:
        make_production_mesh(multi_pod=args.mesh == "multipod")  # raises: a world of one
    if not dist.is_initialized():
        if "WORLD_SIZE" in os.environ:  # torchrun
            device = init_world(int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"]),
                                args.device, "env://")
        else:
            device = init_world(0, 1, args.device, f"file://{fresh_store()}")
    else:
        device = rank_device(args.device, dist.get_world_size(), dist.get_rank())
    if args.mesh != "none":
        return make_production_mesh(multi_pod=args.mesh == "multipod", device=device), device
    shape = tuple(int(n) for n in args.mesh_shape.split("x"))
    if len(shape) != 2:
        raise ValueError(f"--mesh-shape {args.mesh_shape!r} is not DxM")
    return make_mesh(shape, ("data", "model"), device), device


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--full", action="store_true",
                    help="the published widths and depth (default: reduced)")
    ap.add_argument("--mesh", default="none", choices=["none", "pod", "multipod"],
                    help="the production mesh: 16x16 (256 ranks) or 2x16x16 (512)")
    ap.add_argument("--mesh-shape", default="",
                    help="a ('data', 'model') mesh DxM over the world, e.g. 2x1")
    ap.add_argument("--ckpt", default="")
    ap.add_argument("--ckpt-interval", type=int, default=100)
    ap.add_argument("--restore", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--log-every", type=int, default=1)
    ap.add_argument("--kernel", default="cuda", choices=KERNEL_IMPLS,
                    help="cfg.kernel_impl: 'cuda' runs attention on the "
                         "flash_attention kernel (its plain version on the "
                         "CPU); 'reference' the dense torch attention")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    return ap.parse_args(argv)


def main(argv=None) -> dict:
    """Train; returns {"losses", "state", "start", "cursor_at_start",
    "data_cursor", "seconds", "step_s", "graph_stats", "mesh",
    "placements"}: the first step run (the restored step, or 0), the data
    cursor there and at the end, each step's host seconds up to its loss
    read, the step graph's ``GraphCache.stats()`` (None for an eager
    step), and under a mesh the mesh and the state's placements (the
    rank's state holds its slices)."""
    args = parse_args(argv)
    device = resolve_device(args.device)
    cfg = get_config(args.arch)
    if not args.full:
        cfg = reduced(cfg)
    cfg = dataclasses.replace(cfg, kernel_impl=args.kernel)
    if cfg.max_decode_ctx and args.seq > cfg.max_decode_ctx:
        raise ValueError(f"--seq {args.seq} exceeds {cfg.name}'s max_decode_ctx "
                         f"{cfg.max_decode_ctx}")
    mesh, device = build_mesh(args, device)
    lead = mesh is None or dist.get_rank() == 0
    set_current_mesh(mesh)
    try:
        api = get_model(cfg)
        state, _ = build_state(cfg, api, device, args.seed, mesh)
        places = state_placements(cfg, api, mesh)[1] if mesh is not None else None
        if lead:
            how = ("eager (CPU)" if device.type != "cuda" else "CUDA graph" if mesh is None
                   else "CUDA graphs between the mesh's collectives")
            print(f"arch={cfg.name} params={n_params(api.param_spec(cfg)):,} on {device} "
                  f"(kernel_impl={cfg.kernel_impl}, mesh={mesh and mesh.shape}, step: {how})",
                  flush=True)

        ds = SyntheticTokens(cfg, args.batch, args.seq, seed=args.seed)
        mgr = CheckpointManager(args.ckpt, interval=args.ckpt_interval, shardings=places,
                                mesh=mesh) if args.ckpt else None
        start = 0
        if args.restore and args.ckpt:
            last = latest_step(args.ckpt)
            if last is not None:
                state, extra = restore_checkpoint(args.ckpt, last, state, places, mesh)
                ds.seek(extra.get("data_cursor", 0))
                start = int(last)
                if lead:
                    print(f"restored step {start} (data cursor {extra.get('data_cursor')})",
                          flush=True)

        # Read before the loader's thread starts drawing: it prefetches
        # ahead, so the steps' own cursor is counted from here.
        cursor0 = ds.state()["cursor"]
        _, entries = input_specs(cfg, ShapeCell("train", args.seq, args.batch, "train"))
        loader = ShardedLoader(ds, mesh, entries, device)
        step_fn = make_train_step(cfg, api, mesh=mesh)
        t0 = time.time()
        losses, step_s = [], []
        try:
            for i, batch in zip(range(start, args.steps), loader):
                t = time.perf_counter()
                with global_batch(args.batch):
                    state, metrics = step_fn(state, batch)
                losses.append(float(metrics["loss"]))
                step_s.append(time.perf_counter() - t)
                if lead and i % args.log_every == 0:
                    print(f"step {i:5d} loss={losses[-1]:.4f} lr={float(metrics['lr']):.2e} "
                          f"({time.time() - t0:.1f}s)", flush=True)
                if mgr is not None:
                    mgr.maybe_save(i + 1, state, {"data_cursor": cursor0 + (i + 1 - start)})
        finally:
            if mgr is not None:
                mgr.finalize()
            loader.close()
    finally:
        set_current_mesh(None)
    seconds = time.time() - t0
    graphs = getattr(step_fn, "graphs", None)
    if lead:
        print(f"done: {args.steps - start} steps in {seconds:.1f}s", flush=True)
    return {"losses": losses, "state": state, "start": start, "cursor_at_start": cursor0,
            "data_cursor": cursor0 + len(losses), "seconds": seconds, "step_s": step_s,
            "graph_stats": graphs.stats() if graphs is not None else None, "mesh": mesh,
            "placements": places}


if __name__ == "__main__":
    main()
