"""Quickstart — the paper's Listing 1, on the PyTorch port.

A single data-parallel kernel co-executed across every device of the
machine, the host CPU and each CUDA card (``discover(DeviceMask.ALL)``),
under the adaptive HGuided scheduler:

    PYTHONPATH=src python examples/quickstart_torch.py               # CPU + GPU
    PYTHONPATH=src python examples/quickstart_torch.py --device cpu  # CPU only

Without ``--device cpu`` it needs a CUDA card and raises when there is none.
"""
import argparse

import numpy as np

from repro_torch.core import DeviceMask, EngineCL, HGuided, Program, discover


def kernel(offset, x, a, b):
    """y = a*x^2 + b on one package of x (a tensor on the group's device)."""
    return a * x * x + b


def listing1(groups, n: int = 1 << 22, lws: int = 256) -> dict:
    """Run the kernel over ``n`` work-items on ``groups``; returns whether
    the output is right and the run's introspector summary."""
    x = np.linspace(-1, 1, n).astype(np.float32)
    y = np.zeros(n, np.float32)

    engine = EngineCL()
    engine.use(*groups)
    engine.scheduler(HGuided(k=2, adaptive=True))

    program = Program()
    program.in_(x)
    program.out(y)
    program.kernel(kernel, "poly")
    program.args(3.0, -1.0)
    program.work_items(n, lws)

    engine.program(program)
    with engine:
        engine.run()
        if engine.has_errors():
            raise SystemExit("\n".join(engine.get_errors()))
        summary = engine.introspector.summary()
    correct = bool(np.allclose(y, 3.0 * x * x - 1.0, atol=1e-5))
    return {"correct": correct, "summary": summary}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="all", choices=["all", "cpu"],
                    help="all: the CPU and every CUDA card; cpu: the CPU alone")
    ap.add_argument("--n", type=int, default=1 << 22, help="work-items")
    args = ap.parse_args(argv)
    groups = discover(DeviceMask.CPU if args.device == "cpu" else DeviceMask.ALL)
    if args.device == "all" and not any(g.device.type == "cuda" for g in groups):
        raise RuntimeError("CUDA is not available; pass --device cpu to run on the CPU")
    out = listing1(groups, args.n)
    s = out["summary"]
    print("groups:", [g.name for g in groups])
    print("correct:", out["correct"])
    print(f"balance={s['balance']:.3f}  packages={s['n_packages']}  "
          f"work_share={ {k: round(v, 3) for k, v in s['work_share'].items()} }")
    return out


if __name__ == "__main__":
    main()
