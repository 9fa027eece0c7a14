"""End-to-end training on the PyTorch port: config -> data -> train step ->
checkpoint, the counterpart of ``train_lm.py``.

Default settings train a ~11M-parameter qwen-family model for 200 steps;
``--params 100m --steps 300`` is the larger run.  Shows the loss curve,
periodic asynchronous checkpoints, restart (``--restore``) and gradient
accumulation:

    PYTHONPATH=src python examples/train_lm_torch.py --steps 200              # on the card
    PYTHONPATH=src python examples/train_lm_torch.py --steps 300 --restore    # resume
    PYTHONPATH=src python examples/train_lm_torch.py --device cpu --steps 20

Without ``--device cpu`` it needs a CUDA card and raises when there is none.
"""
import argparse
import dataclasses
import time

import torch

from repro_torch import resolve_device
from repro_torch.ckpt import CheckpointManager, latest_step, restore_checkpoint
from repro_torch.configs import get_config, reduced
from repro_torch.data import DeviceLoader, SyntheticTokens
from repro_torch.launch.train import build_state, n_params
from repro_torch.models import get_model
from repro_torch.train import make_train_step


def sized_config(size: str, kernel: str):
    base = dataclasses.replace(reduced(get_config("qwen1.5-4b")), kernel_impl=kernel)
    if size == "tiny":  # ~11M (default)
        return dataclasses.replace(base, name="qwen-tiny", n_layers=4, d_model=256,
                                   n_heads=4, n_kv_heads=4, d_ff=1024, vocab=8192)
    if size == "100m":  # the larger run
        return dataclasses.replace(base, name="qwen-100m", n_layers=12, d_model=768,
                                   n_heads=12, n_kv_heads=12, d_ff=3072, vocab=32768,
                                   remat="dots", microbatches=2)
    raise SystemExit(f"unknown size {size}")


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--params", default="tiny", choices=["tiny", "100m"])
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--ckpt", default="train_lm_ckpt")
    ap.add_argument("--restore", action="store_true")
    ap.add_argument("--kernel", default="cuda", choices=["cuda", "reference"])
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args()

    device = resolve_device(args.device)
    cfg = sized_config(args.params, args.kernel)
    api = get_model(cfg)
    state, _ = build_state(cfg, api, device, 0)
    print(f"model={cfg.name} params={n_params(state['params']) / 1e6:.1f}M  "
          f"batch={args.batch}x{args.seq} on {device}")

    ds = SyntheticTokens(cfg, args.batch, args.seq, seed=0)
    mgr = CheckpointManager(args.ckpt, interval=50, keep=2)
    start = 0
    if args.restore:
        last = latest_step(args.ckpt)
        if last is not None:
            state, extra = restore_checkpoint(args.ckpt, last, state)
            ds.seek(extra["data_cursor"])
            start = last
            print(f"resumed from step {start}")

    step_fn = make_train_step(cfg, api, lr_kwargs={"peak": 1e-3, "warmup": 50,
                                                   "decay_steps": args.steps})
    cursor0 = ds.state()["cursor"]  # before the loader prefetches ahead
    loader = DeviceLoader(ds, device)
    t0 = time.time()
    for i, batch in zip(range(start, args.steps), loader):
        state, m = step_fn(state, batch)
        if i % 10 == 0 or i == args.steps - 1:
            toks = args.batch * args.seq * (i + 1 - start)
            print(f"step {i:4d}  loss={float(m['loss']):.4f}  "
                  f"lr={float(m['lr']):.2e}  {toks / max(time.time() - t0, 1e-9):,.0f} tok/s",
                  flush=True)
        mgr.maybe_save(i + 1, state, {"data_cursor": cursor0 + (i + 1 - start)})
    mgr.finalize()
    loader.close()
    if device.type == "cuda":
        torch.cuda.synchronize()
    print(f"done in {time.time() - t0:.1f}s; checkpoints in {args.ckpt}")


if __name__ == "__main__":
    main()
