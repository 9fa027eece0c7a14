"""Training launcher: config -> data -> train step -> checkpoint/restart.

    # on the card, full widths (whisper-tiny trains whole on one H100)
    PYTHONPATH=src python -m repro_torch.launch.train --arch whisper-tiny --full \\
        --steps 4 --batch 8 --seq 64 --ckpt /tmp/ck --ckpt-interval 2
    PYTHONPATH=src python -m repro_torch.launch.train --arch whisper-tiny --full \\
        --steps 6 --batch 8 --seq 64 --ckpt /tmp/ck --restore

    # on the CPU, reduced config
    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen1.5-4b --device cpu

The JAX launcher's flags, less ``--mesh`` (the device mesh is ROADMAP.md
A11), plus ``--kernel`` (``cfg.kernel_impl``: ``cuda`` runs every Sq > 1
attention on the ``flash_attention`` kernel through its autograd Function;
the rest of the train step is the reference's computations either way) and
``--device`` (``cuda`` unless ``cpu`` is asked for; raises without a card).
The state (float32 parameters, AdamW's m and v, the step) is drawn from
``--seed`` on the device; batches are ``SyntheticTokens(seed=--seed)``,
prefetched onto the device.  ``--restore`` resumes from the latest
checkpoint under ``--ckpt``, the data cursor from its manifest.
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import torch

from repro_torch import resolve_device
from repro_torch.ckpt import CheckpointManager, latest_step, restore_checkpoint
from repro_torch.configs import get_config, reduced
from repro_torch.data import DeviceLoader, SyntheticTokens
from repro_torch.models import KERNEL_IMPLS, get_model
from repro_torch.models.params import materialize, tree_leaves
from repro_torch.train import make_train_step, state_spec


def build_state(cfg, api, device, seed: int):
    """(state, its Spec tree): float32 masters and zero m, v and step,
    drawn on ``device`` from ``seed``."""
    sspec = state_spec(cfg, api.param_spec(cfg))
    gen = torch.Generator(device=device).manual_seed(seed)
    return materialize(sspec, gen, torch.float32, device), sspec


def n_params(params) -> int:
    return sum(t.numel() for t in tree_leaves(params))


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--full", action="store_true",
                    help="the published widths and depth (default: reduced)")
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
    "data_cursor", "seconds"}: the first step run (the restored step, or
    0) and the data cursor there and at the end."""
    args = parse_args(argv)
    device = resolve_device(args.device)
    cfg = get_config(args.arch)
    if not args.full:
        cfg = reduced(cfg)
    cfg = dataclasses.replace(cfg, kernel_impl=args.kernel)
    if cfg.max_decode_ctx and args.seq > cfg.max_decode_ctx:
        raise ValueError(f"--seq {args.seq} exceeds {cfg.name}'s max_decode_ctx "
                         f"{cfg.max_decode_ctx}")
    api = get_model(cfg)
    state, _ = build_state(cfg, api, device, args.seed)
    print(f"arch={cfg.name} params={n_params(state['params']):,} on {device} "
          f"(kernel_impl={cfg.kernel_impl})", flush=True)

    ds = SyntheticTokens(cfg, args.batch, args.seq, seed=args.seed)
    mgr = CheckpointManager(args.ckpt, interval=args.ckpt_interval) if args.ckpt else None
    start = 0
    if args.restore and args.ckpt:
        last = latest_step(args.ckpt)
        if last is not None:
            state, extra = restore_checkpoint(args.ckpt, last, state)
            ds.seek(extra.get("data_cursor", 0))
            start = int(last)
            print(f"restored step {start} (data cursor {extra.get('data_cursor')})", flush=True)

    # Read before the loader's thread starts drawing: it prefetches ahead,
    # so the steps' own cursor is counted from here.
    cursor0 = ds.state()["cursor"]
    loader = DeviceLoader(ds, device)
    step_fn = make_train_step(cfg, api)
    t0 = time.time()
    losses = []
    try:
        for i, batch in zip(range(start, args.steps), loader):
            state, metrics = step_fn(state, batch)
            losses.append(float(metrics["loss"]))
            if i % args.log_every == 0:
                print(f"step {i:5d} loss={losses[-1]:.4f} lr={float(metrics['lr']):.2e} "
                      f"({time.time() - t0:.1f}s)", flush=True)
            if mgr is not None:
                mgr.maybe_save(i + 1, state, {"data_cursor": cursor0 + (i + 1 - start)})
    finally:
        if mgr is not None:
            mgr.finalize()
        loader.close()
    seconds = time.time() - t0
    print(f"done: {args.steps - start} steps in {seconds:.1f}s", flush=True)
    return {"losses": losses, "state": state, "start": start, "cursor_at_start": cursor0,
            "data_cursor": cursor0 + len(losses), "seconds": seconds}


if __name__ == "__main__":
    main()
