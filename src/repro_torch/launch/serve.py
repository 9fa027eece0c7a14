"""Serving launcher: one-shot batched greedy generate.

    # on the card, through the CUDA kernels (the default)
    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen1.5-4b --full \\
        --requests 8 --prompt-len 256 --gen 32

    # on the CPU, reduced config, kernels' plain versions
    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen1.5-4b --device cpu

Weights are random (float32 masters drawn from ``--seed`` on the device,
cast once to the compute dtype); prompts are random tokens from
``--seed + 1``.  The co-executed (``--coexec``) and server (``--server``)
modes of the JAX launcher wait for the runtime and server slices
(ROADMAP.md).
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs import ShapeCell, get_config, reduced
from repro_torch.launch.specs import make_batch
from repro_torch.models import KERNEL_IMPLS, get_model
from repro_torch.models.params import materialize
from repro_torch.serve import make_generate


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=8)
    ap.add_argument("--full", action="store_true",
                    help="the published widths and depth (default: reduced)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--kernel", default="cuda", choices=KERNEL_IMPLS,
                    help="cfg.kernel_impl: 'cuda' runs prefill attention and "
                         "every decode step through the CUDA kernels (their "
                         "plain versions on the CPU); 'reference' the dense "
                         "torch paths")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    return ap.parse_args(argv)


def load_model(args):
    """(cfg, api, float32 params on the device) for the parsed flags."""
    device = resolve_device(args.device)
    cfg = get_config(args.arch)
    if not args.full:
        cfg = reduced(cfg)
    cfg = dataclasses.replace(cfg, kernel_impl=args.kernel)
    api = get_model(cfg)
    gen = torch.Generator(device=device).manual_seed(args.seed)
    params = materialize(api.param_spec(cfg), gen, torch.float32, device)
    return cfg, api, params


def load_batch(cfg, args) -> dict:
    cell = ShapeCell("serve", args.prompt_len, args.requests, "prefill")
    batch = make_batch(cfg, cell, args.seed + 1)
    device = resolve_device(args.device)
    return {k: torch.from_numpy(v).to(device) for k, v in batch.items()}


def run_oneshot(cfg, api, params, batch, gen: int):
    """Plain batched generate through the shared prefill+chain helper."""
    return make_generate(cfg, api)(params, batch, gen)


def main(argv=None) -> dict:
    args = parse_args(argv)
    cfg, api, params = load_model(args)
    batch = load_batch(cfg, args)
    cuda = batch["tokens"].device.type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    toks = run_oneshot(cfg, api, params, batch, args.gen).cpu().numpy()
    wall = time.perf_counter() - t0
    result = {
        "tokens": toks,
        "wall_s": wall,
        "tokens_per_s": toks.size / wall,
        "peak_memory_bytes": torch.cuda.max_memory_allocated() if cuda else None,
    }
    where = torch.cuda.get_device_name() if cuda else "cpu"
    mem = (f", peak memory {result['peak_memory_bytes'] / 2**30:.2f} GiB"
           if cuda else "")
    print(f"generated {toks.shape} on {where} ({cfg.name}, kernel_impl="
          f"{cfg.kernel_impl}) in {wall:.3f}s: {result['tokens_per_s']:.1f} "
          f"tokens/s{mem}")
    print(np.asarray(toks[: min(4, args.requests)]))
    return result


if __name__ == "__main__":
    main()
