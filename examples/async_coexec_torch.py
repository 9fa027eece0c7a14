"""Async co-execution on the PyTorch port — the persistent runtime's
Future-based API, the counterpart of ``async_coexec.py``.

Two independent Programs in flight at once on the same long-lived device
workers (paper §10's multi-kernel execution, made asynchronous), then an
iterative run that hits the device-resident transfer cache.  Both groups
live on the run's device (on the card, each with a CUDA stream of its own):

    PYTHONPATH=src python examples/async_coexec_torch.py               # on the card
    PYTHONPATH=src python examples/async_coexec_torch.py --device cpu  # on the CPU

Without ``--device cpu`` it needs a CUDA card and raises when there is none.
"""
import argparse

import numpy as np

from repro_torch import resolve_device
from repro_torch.core import DeviceGroup, Dynamic, EngineCL, Program

N, LWS = 1 << 16, 64


def poly(offset, x, a, b):
    return a * x * x + b


def damp(offset, s, c):
    return s * c


def async_coexec(device, n: int = N, lws: int = LWS) -> dict:
    """Two Programs in flight on groups "fast" (power 3) and "slow" (power
    1) of ``device`` under Dynamic(8), then ``run_iterative(5)`` whose
    constant ``coeff`` input is a cache hit after the first iteration;
    returns the outputs, the checks, the packages and each group's
    transfer stats."""
    engine = EngineCL()
    engine.use(
        DeviceGroup("fast", device, power=3.0),
        DeviceGroup("slow", device, power=1.0),
    )
    engine.scheduler(Dynamic(8))
    with engine:
        # --- two Programs in flight on the same persistent workers --------
        x1, y1 = np.linspace(-1, 1, n).astype(np.float32), np.zeros(n, np.float32)
        x2, y2 = np.linspace(0, 2, n).astype(np.float32), np.zeros(n, np.float32)
        p1 = Program().in_(x1).out(y1).kernel(poly).args(3.0, -1.0).work_items(n, lws)
        p2 = Program().in_(x2).out(y2).kernel(poly).args(-2.0, 5.0).work_items(n, lws)

        h1, h2 = engine.submit(p1), engine.submit(p2)
        h1.result()  # blocks; raises RunError on kernel failure
        h2.result()
        out = {"y1": y1, "y2": y2,
               "p1_correct": bool(np.allclose(y1, 3 * x1 * x1 - 1, atol=1e-5)),
               "p2_correct": bool(np.allclose(y2, -2 * x2 * x2 + 5, atol=1e-5)),
               "p1_packages": h1.metrics["n_packages"],
               "p2_packages": h2.metrics["n_packages"]}

        # --- iterative run: unchanged buffers stay device-resident --------
        state = np.full(n, 1024.0, np.float32)
        coeff = np.full(n, 0.5, np.float32)  # constant -> cached after iteration 1
        res = np.zeros(n, np.float32)
        it = Program().in_(state).in_(coeff).out(res).kernel(damp).work_items(n, lws)
        engine.program(it).run_iterative(5, swap=[(0, 0)])
        if engine.has_errors():
            raise SystemExit("\n".join(engine.get_errors()))
        out["iter_correct"] = bool(np.allclose(it._ins[0].numpy(), 32.0))
        out["transfer_stats"] = {g.name: g.transfer_stats() for g in engine._groups}
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)
    out = async_coexec(resolve_device(args.device))
    print("p1 correct:", out["p1_correct"], " p2 correct:", out["p2_correct"])
    print("p1 packages:", out["p1_packages"], " p2 packages:", out["p2_packages"])
    print("iterative correct:", out["iter_correct"])
    for name, st in out["transfer_stats"].items():
        print(f"  {name}: {st}")
    return out


if __name__ == "__main__":
    main()
