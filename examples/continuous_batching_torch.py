"""Continuous-batching inference server on the PyTorch port, the
counterpart of ``continuous_batching.py``.

Independent requests arrive over time; the server pads them into shape
buckets, batches them into shared KV-cache slot groups, and decodes in
fixed-length segments — requests exit and join *between* segments, so the
decode batch stays full under staggered arrivals.  Every result is
bit-identical to running that request alone through one-shot generate.

    PYTHONPATH=src python examples/continuous_batching_torch.py               # on the card
    PYTHONPATH=src python examples/continuous_batching_torch.py --device cpu  # on the CPU
    PYTHONPATH=src python examples/continuous_batching_torch.py --full --depth 8

The model is reduced qwen1.5-4b; ``--full`` takes its published widths and
``--depth N`` cuts it to N layers.  Without ``--device cpu`` it needs a
CUDA card and raises when there is none.
"""
import argparse
import contextlib
import dataclasses
import time

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs import get_config, reduced
from repro_torch.core import DeviceGroup
from repro_torch.models import get_model
from repro_torch.models.params import materialize
from repro_torch.serve import InferenceServer, make_generate

ARCH = "qwen1.5-4b"
PLEN, GEN, N = 8, 6, 12
SEG_LEN = 2  # decode segment length: the join/exit quantum


def model(full: bool = False, depth: int = 0, device="cuda", seed: int = 0):
    """(cfg, api, float32 params on ``device``, the uncut layer count):
    reduced qwen1.5-4b, or its published widths (``full``), cut to
    ``depth`` layers (0: all of them), through the port's kernels."""
    cfg = get_config(ARCH) if full else reduced(get_config(ARCH))
    layers = cfg.n_layers
    cfg = dataclasses.replace(cfg, kernel_impl="cuda", n_layers=depth or layers)
    api = get_model(cfg)
    gen = torch.Generator(device=device).manual_seed(seed)
    return cfg, api, materialize(api.param_spec(cfg), gen, torch.float32, device), layers


def continuous_batching(cfg, api, params, device, n: int = N, plen: int = PLEN,
                        gen: int = GEN, around=None) -> dict:
    """Serve ``n`` requests of ``plen`` prompt tokens and ``gen`` new ones,
    arriving Poisson-ish 5 ms apart, through one group of ``device``; hold
    every result bitwise equal to one-shot generate of its prompt alone.
    ``around(name)``: a context manager around the server's run ("server")
    and around the one-shot runs ("one-shot") (default none).  Returns the
    prompts, results, stats and latencies."""
    around = around or (lambda name: contextlib.nullcontext())
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab, plen).astype(np.int32) for _ in range(n)]

    server = InferenceServer(
        cfg, api, params,
        groups=[DeviceGroup("serve:0", device)],
        buckets=(plen,),      # prompts are right-padded to a shape bucket
        max_batch=4,          # KV slots per bucket group
        seg_len=SEG_LEN,
        max_new_cap=gen,
    )
    with around("server"), server:
        handles = []
        for p, gap in zip(prompts, rng.exponential(5e-3, n)):
            time.sleep(gap)  # Poisson-ish arrivals
            handles.append(server.submit(p, gen, deadline_s=120.0))
        results = [h.result(timeout=300) for h in handles]
        stats = server.stats()

    reference = make_generate(cfg, api)
    with around("one-shot"):
        oneshot = [reference(params, {"tokens": torch.from_numpy(p[None]).to(device)}, gen)
                   .cpu().numpy()[0] for p in prompts]
    for got, want in zip(results, oneshot):
        assert np.array_equal(got, want), (got, want)
    lat = sorted(h.metrics["latency"] for h in handles)
    return {"prompts": prompts, "results": results, "oneshot": oneshot, "stats": stats,
            "latency": lat}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--full", action="store_true", help="qwen1.5-4b's published widths")
    ap.add_argument("--depth", type=int, default=0, help="cut the model to N layers")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    cfg, api, params, layers = model(args.full, args.depth, device)
    print(f"{ARCH} {'full width' if args.full else 'reduced'}, {cfg.n_layers} of {layers} "
          f"layers, on {device}")
    out = continuous_batching(cfg, api, params, device)
    stats, lat, n = out["stats"], out["latency"], len(out["results"])
    print(f"served {stats['completed']}/{n} requests, "
          f"mean decode occupancy {stats['mean_occupancy']:.2f} "
          f"({stats['midstream_joins']} joined mid-stream), "
          f"p50 latency {lat[n // 2] * 1e3:.0f}ms")
    print("all results bit-identical to one-shot generate")
    return out


if __name__ == "__main__":
    main()
