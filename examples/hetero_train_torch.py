"""Heterogeneous data-parallel training on the PyTorch port: EngineCL
scheduling applied to training, the counterpart of ``hetero_train.py``.

Two unequal groups train one model: the adaptive rater partitions each
global batch by measured throughput, and the groups' gradients combine on
the host with optional int8 + error-feedback compression.  By default the
groups are ``discover()``'s, the host CPU and each CUDA card, which really
differ; ``--device cpu`` uses two CPU groups, one slowed 4x
(``sim_time_per_wi``), as the reference's simulated pods:

    PYTHONPATH=src python examples/hetero_train_torch.py --steps 30 --compress
    PYTHONPATH=src python examples/hetero_train_torch.py --device cpu --steps 30

Without ``--device cpu`` it needs a CUDA card and raises when there is none.
"""
import argparse

from repro_torch import resolve_device
from repro_torch.configs import get_config, reduced
from repro_torch.core import DeviceGroup, DeviceMask, discover
from repro_torch.data import SyntheticTokens
from repro_torch.launch.train import build_state
from repro_torch.models import get_model
from repro_torch.train.hetero import HeteroTrainer


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=30)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--compress", action="store_true")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args()

    device = resolve_device(args.device)
    cfg = reduced(get_config("internlm2-20b"))
    api = get_model(cfg)
    state, _ = build_state(cfg, api, device, 0)

    if device.type == "cuda":
        groups = discover(DeviceMask.ALL)
    else:
        groups = [DeviceGroup("pod-fast", "cpu", power=1.0, sim_time_per_wi=2e-3),
                  DeviceGroup("pod-slow", "cpu", power=1.0, sim_time_per_wi=8e-3)]
    trainer = HeteroTrainer(cfg, api, groups, compress=args.compress,
                            lr_kwargs={"peak": 1e-3, "warmup": 10, "decay_steps": args.steps})
    ds = SyntheticTokens(cfg, args.batch, args.seq, seed=0)
    for i, batch in zip(range(args.steps), ds):
        state, m = trainer.step(state, batch)
        if i % 5 == 0 or i == args.steps - 1:
            print(f"step {i:3d} loss={m['loss']:.4f} shares={m['shares']} "
                  f"powers={[f'{p:.3g}' for p in m['powers']]} groups="
                  f"{[g.name for g in groups]}", flush=True)
    trainer.shutdown()
    print("note: the shares follow the groups' measured speeds -- the paper's HGuided")
    print("computing-power parameter, learned online (straggler mitigation).")


if __name__ == "__main__":
    main()
