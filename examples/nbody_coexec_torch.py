"""NBody co-execution — the paper's Listing 2, on the PyTorch port, the
counterpart of ``nbody_coexec.py``.

Three heterogeneous device groups, per-device kernel *specialization* (the
"gpu" group runs an fp32 fused rsqrt kernel), and the Static scheduler with
explicit proportions.  On the card "cpu" runs on the host CPU and "phi" and
"gpu" on cuda:0, each with a CUDA stream of its own:

    PYTHONPATH=src python examples/nbody_coexec_torch.py               # CPU + GPU
    PYTHONPATH=src python examples/nbody_coexec_torch.py --device cpu  # CPU only

Without ``--device cpu`` it needs a CUDA card and raises when there is none.
"""
import argparse

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core import DeviceGroup, EngineCL, Program, Static

N_BODIES = 4096


def nbody_kernel(offset, pos, vel, all_pos, dt, eps):
    """One Euler step (work-item = body).  pos/vel: (n, 4); all_pos: (N, 4),
    moved to the package's device."""
    all_pos = all_pos.to(pos.device)
    p = pos[:, :3]
    d = all_pos[None, :, :3] - p[:, None, :]  # (n, N, 3)
    r2 = torch.sum(d * d, dim=-1) + eps
    inv_r3 = torch.where(r2 > eps, r2 ** -1.5, 0.0)
    acc = torch.sum(d * (all_pos[None, :, 3] * inv_r3)[..., None], dim=1)
    new_vel = vel[:, :3] + acc * dt
    new_pos = p + new_vel * dt
    return (torch.cat([new_pos, pos[:, 3:]], dim=1),
            torch.cat([new_vel, vel[:, 3:]], dim=1))


def gpu_kernel(offset, pos, vel, all_pos, dt, eps):
    """Specialized: rsqrt-fused force accumulation (what you'd hand a GPU)."""
    all_pos = all_pos.to(pos.device)
    p = pos[:, :3]
    d = all_pos[None, :, :3] - p[:, None, :]
    r2 = torch.sum(d * d, dim=-1) + eps
    inv_r = torch.where(r2 > eps, torch.reciprocal(torch.sqrt(r2)), 0.0)
    acc = torch.sum(d * (all_pos[None, :, 3] * inv_r ** 3)[..., None], dim=1)
    new_vel = vel[:, :3] + acc * dt
    new_pos = p + new_vel * dt
    return (torch.cat([new_pos, pos[:, 3:]], dim=1),
            torch.cat([new_vel, vel[:, 3:]], dim=1))


def make_nbody(n_bodies: int = 8192, device="cpu") -> dict:
    """The NBody case of the benchmark suite: seeded bodies (positions with
    a mass in column 3, velocities), dt and the softening eps; ``all_pos``,
    the t = 0 positions every package reads, on ``device``."""
    rng = np.random.default_rng(2)
    pos = rng.normal(size=(n_bodies, 4)).astype(np.float32)
    pos[:, 3] = rng.uniform(0.5, 2.0, n_bodies)  # mass
    vel = (rng.normal(size=(n_bodies, 4)) * 0.1).astype(np.float32)
    dt, eps = 0.005, 500.0
    return {"ins": [pos, vel], "outs": [np.zeros_like(pos), np.zeros_like(vel)],
            "args": [torch.from_numpy(pos.copy()).to(device), dt, eps],
            "gws": n_bodies, "lws": 64}


def nbody(device, n_bodies: int = N_BODIES, iters: int = 3) -> dict:
    """Listing 2 on groups cpu (the host), phi and gpu (``device``) under
    Static(props=[0.08, 0.3]); then ``iters`` more steps through
    ``run_iterative`` with (pos, vel) ping-ponged.  Returns the t = 0
    inputs, the state after the first run and after the iterations, each
    held at atol 1e-3 against :func:`reference_steps` (``*_correct``), the
    introspector summary and each group's transfer stats."""
    bench = make_nbody(n_bodies, device)
    start = [x.copy() for x in bench["ins"]]

    engine = EngineCL()
    engine.use(
        DeviceGroup("cpu", "cpu", power=1.0, sim_time_per_wi=2e-6),
        DeviceGroup("phi", device, power=2.0, sim_time_per_wi=1e-6),
        DeviceGroup("gpu", device, power=5.0, sim_time_per_wi=4e-7, kernel=gpu_kernel),
    )
    engine.work_items(bench["gws"], bench["lws"])
    engine.scheduler(Static(props=[0.08, 0.3]))  # paper Listing 2: CPU 8%, PHI 30%

    program = Program()
    program.in_(bench["ins"][0])
    program.in_(bench["ins"][1])
    program.out(bench["outs"][0])
    program.out(bench["outs"][1])
    program.kernel(nbody_kernel, "nbody")
    program.args(*bench["args"])

    with engine:
        engine.program(program)
        engine.run()
        if engine.has_errors():
            raise SystemExit("\n".join(engine.get_errors()))
        first = [x.copy() for x in bench["outs"]]
        summary = engine.introspector.summary()

        # NBody is iterative: continue stepping on the persistent workers,
        # ping-ponging (pos, vel) buffers (frozen-field approximation: the
        # all_pos broadcast arg stays at t=0).  Swap first so the loop starts
        # from the t=1 state just computed instead of redoing step 1.  Each
        # swapped-in (pos, vel) is served from the group's transfer cache,
        # where the run that produced it left it: no iteration uploads.
        program.swap_buffers(0, 0)
        program.swap_buffers(1, 1)
        engine.run_iterative(iters, swap=[(0, 0), (1, 1)])
        if engine.has_errors():
            raise SystemExit("\n".join(engine.get_errors()))
        stats = {g.name: g.transfer_stats() for g in engine._groups}
    last = [program._ins[0].numpy().copy(), program._ins[1].numpy().copy()]
    dt, eps = bench["args"][1:]
    want_pos, want_vel = reference_steps(*start, start[0], dt, eps, 1)
    last_pos, last_vel = reference_steps(*start, start[0], dt, eps, 1 + iters)
    return {"start": start, "dt": dt, "eps": eps, "first": first, "last": last,
            "pos_correct": bool(np.allclose(first[0], want_pos, atol=1e-3)),
            "vel_correct": bool(np.allclose(first[1], want_vel, atol=1e-3)),
            "iter_correct": bool(np.allclose(last[0], last_pos, atol=1e-3)
                                 and np.allclose(last[1], last_vel, atol=1e-3)),
            "summary": summary, "transfer_stats": stats}


def reference_steps(pos, vel, all_pos, dt, eps, steps: int):
    """``steps`` Euler steps by ``nbody_kernel`` on the CPU in one package,
    the all_pos field frozen at t = 0."""
    pos, vel = torch.from_numpy(pos), torch.from_numpy(vel)
    all_pos = torch.from_numpy(all_pos)
    for _ in range(steps):
        pos, vel = nbody_kernel(0, pos, vel, all_pos, dt, eps)
    return pos.numpy(), vel.numpy()


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)
    out = nbody(resolve_device(args.device))
    s = out["summary"]
    print("pos correct:", out["pos_correct"])
    print("vel correct:", out["vel_correct"])
    share = {k: round(v, 2) for k, v in s["work_share"].items()}
    print(f"balance={s['balance']:.3f}  share={share}")
    print("iterative correct:", out["iter_correct"])
    for name, st in out["transfer_stats"].items():
        print(f"{name}: transfers={st['transfers']} cache_hits={st['cache_hits']}")
    return out


if __name__ == "__main__":
    main()
