"""Dataflow pipelines on the PyTorch port — dependency-aware run graphs with
device-resident buffer handoff (paper §10's multi-kernel execution, made
non-blocking), the counterpart of ``pipeline_dataflow.py``.

A 3-stage chain of linked Programs (each stage reads the previous stage's
output buffer) is submitted as ONE run graph: dependencies are inferred
from the shared host buffers, the host never blocks between stages, and the
intermediate buffers are served still-on-device from the transfer cache
instead of round-tripping through host memory:

    PYTHONPATH=src python examples/pipeline_dataflow_torch.py               # on the card
    PYTHONPATH=src python examples/pipeline_dataflow_torch.py --device cpu  # on the CPU

Without ``--device cpu`` it needs a CUDA card and raises when there is none.
"""
import argparse

import numpy as np

from repro_torch import resolve_device
from repro_torch.core import DeviceGroup, EngineCL, Program, Static

N, LWS = 1 << 18, 64


def scale(offset, a):
    return 2.0 * a


def shift(offset, a):
    return a + 1.0


def square(offset, a):
    return a * a


def halve(offset, a):
    return a * 0.5


def pipeline(device, n: int = N, lws: int = LWS) -> dict:
    """The three-stage chain on one group of ``device``, then five
    iterations of halving; returns the checks, the inferred dependencies
    and each group's transfer stats."""
    x = np.linspace(-1.0, 1.0, n).astype(np.float32)
    y = np.zeros(n, np.float32)
    z = np.zeros(n, np.float32)
    w = np.zeros(n, np.float32)

    stage1 = Program().in_(x).out(y).kernel(scale, "scale").work_items(n, lws)
    stage2 = Program().in_(y).out(z).kernel(shift, "shift").work_items(n, lws)
    stage3 = Program().in_(z).out(w).kernel(square, "square").work_items(n, lws)

    group = DeviceGroup("solo", device)
    with EngineCL().use(group).scheduler(Static()) as engine:
        # Non-blocking: all three stages are in flight after this line; the
        # group's worker starts stage N+1 the moment its part of stage N is
        # safe.
        handles = engine.submit_pipeline(stage1, stage2, stage3)
        done_at_submit = handles[-1].done()
        deps = [len(h.deps) for h in handles]  # [0, 1, 1]
        handles[-1].result()  # blocks; raises RunError on any stage failure
    correct = bool(np.allclose(w, (2.0 * x + 1.0) ** 2, atol=1e-5))
    # Device-resident handoff: y and z are never re-uploaded -> 1 transfer.
    stats = group.transfer_stats()

    # Iterative execution uses the same graph path: each iteration's
    # epilogue ping-pongs the buffers on the worker, and the swapped-in
    # output is served device-resident on the next iteration.
    state = np.full(n, 32.0, np.float32)
    out = np.zeros(n, np.float32)
    it = Program().in_(state).out(out).kernel(halve, "halve").work_items(n, lws)
    g2 = DeviceGroup("iter", device)
    with EngineCL().use(g2).scheduler(Static()).program(it) as eng2:
        eng2.run_iterative(5, swap=[(0, 0)])
        if eng2.has_errors():
            raise SystemExit("\n".join(eng2.get_errors()))
    iter_correct = bool(np.allclose(it._ins[0].numpy(), 1.0))
    return {"done_at_submit": done_at_submit, "deps": deps, "correct": correct,
            "transfer_stats": stats, "iter_correct": iter_correct,
            "iter_stats": g2.transfer_stats(), "w": w}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)
    out = pipeline(resolve_device(args.device))
    print("submitted; last stage done?", out["done_at_submit"])
    print("inferred deps:", out["deps"])
    print("correct:", out["correct"])
    print("transfer stats:", out["transfer_stats"])
    print("iterative correct:", out["iter_correct"], " stats:", out["iter_stats"])
    return out


if __name__ == "__main__":
    main()
