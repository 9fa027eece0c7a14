"""Heterogeneous batched serving with straggler mitigation on the PyTorch
port, the counterpart of ``serve_hetero.py``.

Requests are independent → exactly the paper's co-execution regime.  Two
"pods" serve a shared request queue through the adaptive HGuided scheduler;
midway one pod degrades 4x (straggler).  Watch the work share shift — no
operator action, the EMA re-rating does it.  Both pods live on the run's
device (on the card, each with a CUDA stream of its own, replaying a CUDA
graph of the package kernel per package shape), and every token is held
bitwise equal to one-shot generate of the whole request batch:

    PYTHONPATH=src python examples/serve_hetero_torch.py               # on the card
    PYTHONPATH=src python examples/serve_hetero_torch.py --device cpu  # on the CPU
    PYTHONPATH=src python examples/serve_hetero_torch.py --full --depth 4

The model is reduced granite-34b; ``--full`` takes its published widths and
``--depth N`` cuts it to N layers.  Without ``--device cpu`` it needs a
CUDA card and raises when there is none.
"""
import argparse
import contextlib
import dataclasses

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs import get_config, reduced
from repro_torch.core import DeviceGroup, EngineCL, HGuided, Program
from repro_torch.models import get_model
from repro_torch.models.params import materialize
from repro_torch.serve import make_decode_chain, make_generate, make_prefill_step
from repro_torch.serve.step import cast_params_cached, zeros_cache

ARCH = "granite-34b"
N_REQ, PLEN, GEN = 64, 32, 8


def model(full: bool = False, depth: int = 0, device="cuda", seed: int = 0):
    """(cfg, api, float32 params on ``device``, the uncut layer count):
    reduced granite-34b, or its published widths (``full``), cut to
    ``depth`` layers (0: all of them), through the port's kernels."""
    cfg = get_config(ARCH) if full else reduced(get_config(ARCH))
    layers = cfg.n_layers
    cfg = dataclasses.replace(cfg, kernel_impl="cuda", n_layers=depth or layers)
    api = get_model(cfg)
    gen = torch.Generator(device=device).manual_seed(seed)
    return cfg, api, materialize(api.param_spec(cfg), gen, torch.float32, device), layers


def make_kernel(cfg, api, params, plen: int = PLEN, gen: int = GEN):
    """The package kernel: greedy generate of ``gen`` tokens for a package
    of prompts, prefill then a device-resident decode chain."""
    prefill = make_prefill_step(cfg, api)
    chain = make_decode_chain(cfg, api)

    def generate(offset, tokens):
        cache = zeros_cache(cfg, api, tokens.shape[0], plen + gen, device=tokens.device)
        tok, cache = prefill(params, {"tokens": tokens}, cache)
        toks, _, _ = chain(params, cache, tok, plen, gen - 1)
        return torch.cat([tok, toks], dim=1)

    return generate


def serve_hetero(cfg, api, params, device, n_req: int = N_REQ, plen: int = PLEN,
                 gen: int = GEN, around=None) -> dict:
    """Two phases of ``n_req`` requests of ``plen`` + ``gen`` tokens over
    pods pod-a and pod-b of ``device`` under HGuided(k=2, adaptive=True),
    pod-b 4x slower in the second, each phase's tokens held bitwise equal
    to one-shot generate of the whole batch.  ``around(name)``: a context
    manager around each phase's run and the one-shot run (default none).
    Returns each phase's tokens, packages, balance and work shares."""
    around = around or (lambda name: contextlib.nullcontext())
    if device.type == "cuda":
        # Build the kernel libraries here, not on a worker thread.
        from repro_torch.kernels import _build

        _build.build()
    # Cast the parameters once, here, not concurrently on the workers.
    cast_params_cached(params, cfg.compute_dtype)
    tokens = np.random.default_rng(0).integers(0, cfg.vocab, (n_req, plen)).astype(np.int32)
    out = np.zeros((n_req, gen), np.int32)

    pod_a = DeviceGroup("pod-a", device, power=1.0, sim_time_per_wi=4e-3)
    pod_b = DeviceGroup("pod-b", device, power=1.0, sim_time_per_wi=4e-3)
    kernel = make_kernel(cfg, api, params, plen, gen)
    prog = Program().in_(tokens).out(out).kernel(kernel, "generate").work_items(n_req, 2)
    phases = {}
    with EngineCL().use(pod_a, pod_b).scheduler(HGuided(k=2, adaptive=True)) as engine:
        engine.program(prog)
        for name in ("phase 1", "phase 2"):
            if name == "phase 2":
                pod_b.sim_time_per_wi *= 4  # the straggler
            with around(name):
                engine.run()
            if engine.has_errors():
                raise SystemExit("\n".join(engine.get_errors()))
            s = engine.introspector.summary()
            packages = {g.name: [] for g in (pod_a, pod_b)}
            for r in sorted(engine.introspector.records, key=lambda r: r.offset_wi):
                packages[r.device].append(r.size_wi)
            phases[name] = {"tokens": out.copy(), "balance": s["balance"],
                            "work_share": s["work_share"], "packages": packages}
    with around("one-shot"):
        want = make_generate(cfg, api)(params, {"tokens": torch.from_numpy(tokens).to(device)},
                                       gen).cpu().numpy()
    for name, ph in phases.items():
        ph["bitwise"] = bool(np.array_equal(ph["tokens"], want))
    return {"tokens": tokens, "oneshot": want, "phases": phases,
            "graphs": {g.name: g.graphs.stats() for g in (pod_a, pod_b)
                       if g.graphs is not None}}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--full", action="store_true", help="granite-34b's published widths")
    ap.add_argument("--depth", type=int, default=0, help="cut the model to N layers")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    cfg, api, params, layers = model(args.full, args.depth, device)
    print(f"{ARCH} {'full width' if args.full else 'reduced'}, {cfg.n_layers} of {layers} "
          f"layers, on {device}")
    out = serve_hetero(cfg, api, params, device)
    for name, ph in out["phases"].items():
        print(name + (": both pods healthy" if name == "phase 1"
                      else ": pod-b degrades 4x (straggler)"))
        share = {k: round(v, 2) for k, v in ph["work_share"].items()}
        print(f"  balance={ph['balance']:.3f} share={share} packages={ph['packages']}")
        print(f"  bit-identical to one-shot generate: {ph['bitwise']}")
    print("  (adaptive HGuided shifted work toward the healthy pod)")
    if not all(ph["bitwise"] for ph in out["phases"].values()):
        raise SystemExit("co-executed tokens differ from one-shot generate")
    return out


if __name__ == "__main__":
    main()
