"""The port's EngineCL facade (Tier-1 API over the runtime), Program
validation, multi-kernel pipelines and iterative runs, discover() and the
co-execution system cases, held against the JAX package's engine on the
same groups and schedulers where the reference asserts package splits.

Ports of tests/test_engine.py, test_program.py, test_multikernel.py and
the two co-execution cases of test_system.py that need no benchmarks/."""
import types

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro import core as jcore
from repro_torch import core as tcore
from repro_torch.core import (
    DeviceGroup,
    DeviceMask,
    Dynamic,
    EngineCL,
    HGuided,
    Program,
    Static,
    discover,
)
from repro_torch.core import engine as engine_mod


def cpu_group(name, **kw):
    return DeviceGroup(name, device="cpu", **kw)


def saxpy(offset, x):
    return 2.0 * x + 1.0


def make_engine(sched, n=4096, lws=64, n_groups=3):
    x = np.arange(n, dtype=np.float32)
    y = np.zeros(n, np.float32)
    groups = [cpu_group(f"g{i}", power=float(2 ** i)) for i in range(n_groups)]
    prog = Program().in_(x).out(y).kernel(saxpy, "saxpy").work_items(n, lws)
    eng = EngineCL().use(*groups).scheduler(sched).program(prog)
    return eng, x, y


@pytest.mark.parametrize("sched", [Static(), Dynamic(10), HGuided(), HGuided(adaptive=True)],
                         ids=["static", "dynamic", "hguided", "hguided-adaptive"])
def test_coexec_matches_native(sched):
    eng, x, y = make_engine(sched)
    eng.run()
    assert not eng.has_errors(), eng.get_errors()
    np.testing.assert_allclose(y, 2.0 * x + 1.0)


def test_full_coverage_no_overlap_records():
    """Every work-item in exactly one package, and the same packages as
    the JAX engine's on the same groups and scheduler."""
    recs = {}
    for name, core, group in (("jax", jcore, lambda n: jcore.DeviceGroup(n)),
                              ("torch", tcore, cpu_group)):
        x = np.arange(1088, dtype=np.float32)
        y = np.zeros(1088, np.float32)
        eng = core.EngineCL().use(group("a"), group("b")).scheduler(core.Dynamic(17))
        eng.program(core.Program().in_(x).out(y).kernel(lambda o, a: a * 2.0)
                    .work_items(1088, 16)).run()
        assert not eng.has_errors(), eng.get_errors()
        recs[name] = eng.introspector.records
        cover = np.zeros(1088, int)
        for r in recs[name]:
            cover[r.offset_wi: r.offset_wi + r.size_wi] += 1
        assert (cover == 1).all()
        np.testing.assert_allclose(y, 2.0 * x)
    # Which group pulls which package races; the cut is the scheduler's.
    assert (sorted((r.offset_wi, r.size_wi) for r in recs["torch"])
            == sorted((r.offset_wi, r.size_wi) for r in recs["jax"]))


def test_engine_surfaces_kernel_errors():
    def bad(offset, x):
        raise RuntimeError("boom")

    x = np.arange(64, dtype=np.float32)
    y = np.zeros(64, np.float32)
    eng = EngineCL().use(cpu_group("g"))
    eng.program(Program().in_(x).out(y).kernel(bad).work_items(64, 8))
    eng.run()
    assert eng.has_errors()
    assert "boom" in eng.get_errors()[0]


def test_engine_validation_errors_no_crash():
    eng = EngineCL().use(cpu_group("g"))
    eng.run()  # no program
    assert eng.has_errors()


def test_discover_cpu():
    groups = discover(DeviceMask.CPU)
    assert len(groups) == 1
    assert groups[0].name == "cpu:0" and groups[0].device.type == "cpu"


def test_discover_all_on_this_machine():
    """ALL is the CPU and every CUDA card the machine has."""
    cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    names = [g.name for g in discover(DeviceMask.ALL)]
    assert names == ["cpu:0"] + [f"cuda:{i}" for i in range(cards)]
    assert discover(DeviceMask.TPU) == []


@pytest.mark.parametrize("mask,want", [
    (DeviceMask.CPU, [("cpu:0", "cpu")]),
    (DeviceMask.GPU, [("cuda:0", "cuda:0"), ("cuda:1", "cuda:1")]),
    (DeviceMask.TPU, []),
    (DeviceMask.ALL, [("cpu:0", "cpu"), ("cuda:0", "cuda:0"), ("cuda:1", "cuda:1")]),
    (DeviceMask.CPU | DeviceMask.TPU, [("cpu:0", "cpu")]),
])
def test_discover_injected_devices(monkeypatch, mask, want):
    """discover over injected fake devices (a CPU, two cards and a device
    of a type no mask names): one group per device the mask selects, named
    and placed as on a real node.  The groups are recorded, not built, so
    the fake cards need no CUDA."""
    made = []

    def fake_group(name, device=None, **kw):
        made.append((name, device))
        return types.SimpleNamespace(name=name, device=device)

    monkeypatch.setattr(engine_mod, "DeviceGroup", fake_group)
    fakes = [types.SimpleNamespace(type="cpu", index=None),
             types.SimpleNamespace(type="cuda", index=0),
             types.SimpleNamespace(type="cuda", index=1),
             types.SimpleNamespace(type="meta", index=None)]
    groups = discover(mask, devices=fakes)
    assert made == want
    assert [g.name for g in groups] == [n for n, _ in want]


def test_multi_output_program():
    def k(offset, a, b):
        return a + b, a - b

    a = np.arange(256, dtype=np.float32)
    b = np.ones(256, np.float32)
    s1, s2 = np.zeros_like(a), np.zeros_like(a)
    eng = EngineCL().use(cpu_group("g0"), cpu_group("g1"))
    eng.program(Program().in_(a).in_(b).out(s1).out(s2).kernel(k).work_items(256, 16))
    eng.scheduler(Dynamic(4)).run()
    assert not eng.has_errors(), eng.get_errors()
    np.testing.assert_allclose(s1, a + b)
    np.testing.assert_allclose(s2, a - b)


def test_out_pattern_non_unit():
    # 4 work-items produce 1 output element (e.g. reduction per group).
    def k(offset, x):
        return x.reshape(-1, 4).sum(dim=1)

    x = np.arange(256, dtype=np.float32)
    y = np.zeros(64, np.float32)
    eng = EngineCL().use(cpu_group("a"), cpu_group("b"))
    prog = Program().in_(x).out(y).out_pattern(1, 4).kernel(k).work_items(256, 8)
    eng.scheduler(Dynamic(4)).program(prog).run()
    assert not eng.has_errors(), eng.get_errors()
    np.testing.assert_allclose(y, x.reshape(-1, 4).sum(axis=1))


def test_kernel_specialization_per_device():
    """Paper: per-device kernel variants (source/binary) = per-group
    kernels."""
    calls = {"generic": 0, "special": 0}

    def generic(offset, x):
        calls["generic"] += 1
        return x * 2.0

    def specialized(offset, x):
        calls["special"] += 1
        return x + x  # same math, different kernel

    x = np.arange(512, dtype=np.float32)
    y = np.zeros(512, np.float32)
    eng = EngineCL().use(cpu_group("generic"), cpu_group("special", kernel=specialized))
    eng.scheduler(Dynamic(8)).program(
        Program().in_(x).out(y).kernel(generic).work_items(512, 16)
    ).run()
    assert not eng.has_errors(), eng.get_errors()
    np.testing.assert_allclose(y, 2.0 * x)
    per = eng.introspector.per_device()
    assert calls["generic"] == per.get("generic", {}).get("packages", 0)
    assert calls["special"] == per.get("special", {}).get("packages", 0)


# ------------------------------------------------------------ Program


def test_validate_requires_kernel():
    p = Program().out(np.zeros(8)).work_items(8, 1)
    assert any("kernel" in e for e in p.validate())


def test_gws_inferred_from_output():
    p = Program().out(np.zeros(64)).kernel(lambda o, x: x).out_pattern(1, 4)
    p.validate()
    assert p.gws == 256  # 64 outputs * 4 work-items per output


def test_gws_lws_divisibility():
    p = Program().out(np.zeros(10)).kernel(lambda o: None).work_items(10, 4)
    assert any("multiple" in e for e in p.validate())


def test_slice_inputs_ratio():
    x = np.arange(32)
    y = np.arange(8)  # ratio 1:4 vs gws=32
    p = Program().in_(x).in_(y).kernel(lambda o, a, b: a).work_items(32, 4)
    assert not p.validate()
    a, b = p.slice_inputs(8, 16)
    np.testing.assert_array_equal(np.asarray(a), x[8:24])
    np.testing.assert_array_equal(np.asarray(b), y[2:6])


def test_write_outputs_trims_bucket_padding():
    out = np.zeros(16)
    p = Program().out(out).kernel(lambda o: None).work_items(16, 1)
    p.validate()
    p.write_outputs(4, 4, torch.ones(8, dtype=torch.float64))  # longer than the window
    np.testing.assert_array_equal(out[4:8], 1.0)
    assert out[8:].sum() == 0


def test_write_outputs_count_mismatch():
    p = Program().out(np.zeros(4)).kernel(lambda o: None).work_items(4, 1)
    p.validate()
    with pytest.raises(ValueError):
        p.write_outputs(0, 4, (torch.zeros(4), torch.zeros(4)))


# ------------------------------------------------------- multi-kernel


def test_multi_kernel_pipeline_shares_buffers():
    """p1: y = 2x; p2: z = y + 1 (y shared between programs)."""
    n = 1024
    x = np.arange(n, dtype=np.float32)
    y = np.zeros(n, np.float32)
    z = np.zeros(n, np.float32)
    p1 = Program().in_(x).out(y).kernel(lambda o, a: 2.0 * a).work_items(n, 16)
    p2 = Program().in_(y).out(z).kernel(lambda o, a: a + 1.0).work_items(n, 16)
    eng = EngineCL().use(cpu_group("a"), cpu_group("b")).scheduler(Dynamic(4))
    eng.run_pipeline(p1, p2)
    assert not eng.has_errors(), eng.get_errors()
    np.testing.assert_allclose(z, 2.0 * x + 1.0)


def test_iterative_execution_ping_pong():
    """x_{t+1} = x_t * 0.5 run 5 times via buffer ping-pong."""
    n = 512
    x = np.full(n, 1024.0, np.float32)
    y = np.zeros(n, np.float32)
    prog = Program().in_(x).out(y).kernel(lambda o, a: a * 0.5).work_items(n, 8)
    eng = EngineCL().use(cpu_group("solo")).program(prog)
    eng.run_iterative(5, swap=[(0, 0)])
    assert not eng.has_errors(), eng.get_errors()
    # After 5 halvings the latest OUTPUT buffer holds 1024/2^5 = 32.
    latest = prog._ins[0]  # swapped after the final iteration
    np.testing.assert_allclose(np.asarray(latest), 32.0)


def test_iterative_coexec_matches_single_device():
    n = 256
    x0 = np.random.default_rng(0).normal(size=n).astype(np.float32)

    def step(o, a):
        return torch.tanh(a) * 1.1

    def run(groups):
        x = x0.copy()
        y = np.zeros_like(x)
        prog = Program().in_(x).out(y).kernel(step).work_items(n, 8)
        eng = EngineCL().use(*groups).scheduler(HGuided()).program(prog)
        eng.run_iterative(3, swap=[(0, 0)])
        assert not eng.has_errors(), eng.get_errors()
        return np.asarray(prog._ins[0])

    single = run([cpu_group("one")])
    multi = run([cpu_group("a", power=2.0), cpu_group("b", power=1.0)])
    np.testing.assert_allclose(single, multi, atol=1e-6)
    # The JAX engine's answer on the same chain, within float32 tolerance.
    x = x0.copy()
    for _ in range(3):
        x = np.asarray(jnp.tanh(x) * 1.1)
    np.testing.assert_allclose(multi, x, atol=1e-6)


# ------------------------------------------------------------ system


def irregular_program(sim_fast, sim_slow, n=16384, lws=128):
    """An irregular kernel whose cost the groups' simulated speeds charge
    through ``cost_fn``: the last quarter of the work-items costs 8 units
    each, the rest 1 (Mandelbrot's shape: the expensive pixels cluster)."""
    cost = np.where(np.arange(n) >= n - n // 4, 8.0, 1.0)
    prefix = np.concatenate([[0.0], np.cumsum(cost)])
    x = np.arange(n, dtype=np.float32)
    y = np.zeros(n, np.float32)
    prog = Program().in_(x).out(y).kernel(lambda o, a: a * a, "irregular").work_items(n, lws)
    prog.cost_fn = lambda off, size: float(prefix[min(off + size, n)] - prefix[off])
    groups = [cpu_group("fast", power=2.0, sim_time_per_wi=sim_fast),
              cpu_group("slow", power=1.0, sim_time_per_wi=sim_slow)]
    return prog, groups, x, y


def test_hguided_beats_static_on_irregular_load():
    """Paper Fig 9: static misassigns irregular work; HGuided adapts."""

    def run_with(sched):
        prog, groups, x, y = irregular_program(2.5e-6, 5e-6)
        eng = EngineCL().use(*groups).scheduler(sched).program(prog)
        eng.run()  # warm
        eng.run()
        assert not eng.has_errors(), eng.get_errors()
        np.testing.assert_allclose(y, x * x)
        eng.shutdown()
        return eng.introspector.balance()

    bal_static = run_with(Static())  # power-proportional, content-blind
    bal_hg = run_with(HGuided(k=2))
    assert bal_hg >= bal_static - 0.05, (bal_static, bal_hg)
    assert bal_hg > 0.7


def test_generation_identical_under_coexecution():
    """Reduced qwen1.5-4b in float32: one-shot generate as the package
    kernel of a Program over two groups under Dynamic(4) gives the tokens
    of one-shot generate of the whole batch, bitwise."""
    import dataclasses

    from repro_torch.configs import get_config, reduced
    from repro_torch.models import get_model
    from repro_torch.models.params import materialize
    from repro_torch.serve import make_generate

    cfg = dataclasses.replace(reduced(get_config("qwen1.5-4b")), compute_dtype="float32")
    api = get_model(cfg)
    params = materialize(api.param_spec(cfg), torch.Generator().manual_seed(0),
                         torch.float32, torch.device("cpu"))
    n_req, plen, gen = 8, 12, 4
    tokens = np.random.default_rng(1).integers(0, cfg.vocab, (n_req, plen)).astype(np.int32)
    generate = make_generate(cfg, api)
    want = generate(params, {"tokens": torch.from_numpy(tokens)}, gen).numpy()

    def kern(offset, toks):
        return generate(params, {"tokens": toks}, gen)

    out = np.zeros((n_req, gen), np.int32)
    prog = Program().in_(tokens).out(out).kernel(kern).work_items(n_req, 1)
    eng = EngineCL().use(cpu_group("a"), cpu_group("b")).scheduler(Dynamic(4)).program(prog)
    eng.run()
    assert not eng.has_errors(), eng.get_errors()
    np.testing.assert_array_equal(out, want)
    assert eng.introspector.summary()["n_packages"] == 4


def test_jax_engine_still_on_cpu():
    """The two engines run side by side in one process: the JAX package's
    engine stays on its own CPU devices."""
    assert jax.devices()[0].platform == "cpu"


@pytest.mark.parametrize("sched", ["static", "dynamic", "hguided"])
def test_launcher_coexec_verifies_on_cpu(sched, capsys):
    """``launch.serve --coexec --verify``: the requests split over pod-a and
    pod-b by each scheduler, every package a generate of its requests,
    bitwise equal to one-shot generate of the batch."""
    from repro_torch.launch import serve as launcher

    out = launcher.main(["--arch", "qwen1.5-4b", "--device", "cpu", "--coexec",
                         "--scheduler", sched, "--verify", "--requests", "6",
                         "--prompt-len", "8", "--gen", "3", "--seed", "2"])
    assert out["verified"] and out["tokens"].shape == (6, 3)
    assert sum(sum(p) for p in out["packages"].values()) == 6
    assert set(out["packages"]) == {"pod-a", "pod-b"}
    text = capsys.readouterr().out
    assert "verify: co-exec output bit-identical to one-shot generate" in text
