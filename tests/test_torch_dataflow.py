"""The port's dataflow submission through the EngineCL facade: dependency
run graphs, device-resident buffer handoff, failure poisoning and the
executor shutdown contract.  Transfer and cache-hit counts are held equal
to the JAX package's engine on the same groups and schedulers.

Port of tests/test_dataflow.py."""
import time

import numpy as np
import pytest
import torch

from repro import core as jcore
from repro_torch import core as tcore
from repro_torch.core import DeviceGroup, Dynamic, EngineCL, Program, RunError, Static


def cpu_group(name, **kw):
    return DeviceGroup(name, device="cpu", **kw)


BACKENDS = {"jax": (jcore, lambda name, **kw: jcore.DeviceGroup(name, **kw)),
            "torch": (tcore, cpu_group)}


def scale2(offset, a):
    return 2.0 * a


def plus1(offset, a):
    return a + 1.0


def halve(offset, a):
    return a * 0.5


def chain_programs(x, n, lws=16, core=tcore):
    """x -> y=2x -> z=y+1 -> w=z/2, linked through shared host buffers."""
    y = np.zeros(n, np.float32)
    z = np.zeros(n, np.float32)
    w = np.zeros(n, np.float32)
    p1 = core.Program().in_(x).out(y).kernel(scale2).work_items(n, lws)
    p2 = core.Program().in_(y).out(z).kernel(plus1).work_items(n, lws)
    p3 = core.Program().in_(z).out(w).kernel(halve).work_items(n, lws)
    return (p1, p2, p3), w


def output(prog, i=0):
    return np.asarray(prog._outs[i])


# ------------------------------------------------------------- equivalence
def test_pipeline_bit_identical_to_blocking_serial():
    """The non-blocking run graph produces bit-identical outputs to running
    each stage with a blocking run()."""
    n = 2048
    x = np.linspace(-3, 3, n).astype(np.float32)

    progs, w_graph = chain_programs(x.copy(), n)
    eng = EngineCL().use(cpu_group("a"), cpu_group("b")).scheduler(Dynamic(4))
    eng.run_pipeline(*progs)
    assert not eng.has_errors(), eng.get_errors()

    serial, w_serial = chain_programs(x.copy(), n)
    eng2 = EngineCL().use(cpu_group("a"), cpu_group("b")).scheduler(Dynamic(4))
    for p in serial:
        eng2.program(p).run()
        assert not eng2.has_errors(), eng2.get_errors()

    np.testing.assert_array_equal(output(progs[-1]), output(serial[-1]))
    np.testing.assert_array_equal(output(progs[-1]), (2.0 * x + 1.0) * 0.5)


# ----------------------------------------------------- device-resident handoff
def test_pipeline_transfers_prove_device_resident_handoff():
    """Each stage reads what the previous stage produced on the same group:
    only the source buffer is ever host->device transferred, on both
    engines."""
    stats = {}
    for name, (core, group) in BACKENDS.items():
        n = 1024
        x = np.arange(n, dtype=np.float32)
        progs, w = chain_programs(x, n, core=core)
        g = group("solo")
        eng = core.EngineCL().use(g).scheduler(core.Static())
        eng.run_pipeline(*progs)
        assert not eng.has_errors(), eng.get_errors()
        np.testing.assert_allclose(output(progs[-1]), (2.0 * x + 1.0) * 0.5)
        stats[name] = (g.n_transfers, g.n_cache_hits)
    assert stats["torch"] == stats["jax"]
    # 3 stages x 1 input buffer each = 3 worst-case transfers; the two
    # intermediates (y, z) are served still-on-device.
    assert stats["torch"][0] == 1 and stats["torch"][1] >= 2, stats


def test_iterative_swap_hands_off_device_resident():
    """Ping-pong iterations re-consume their own outputs without a single
    re-transfer after the first upload."""
    stats = {}
    n, iters = 512, 6
    for name, (core, group) in BACKENDS.items():
        x = np.full(n, float(2 ** iters), np.float32)
        y = np.zeros(n, np.float32)
        g = group("solo")
        prog = core.Program().in_(x).out(y).kernel(halve).work_items(n, 8)
        eng = core.EngineCL().use(g).scheduler(core.Static()).program(prog)
        eng.run_iterative(iters, swap=[(0, 0)])
        assert not eng.has_errors(), eng.get_errors()
        np.testing.assert_allclose(np.asarray(prog._ins[0]), 1.0)
        stats[name] = (g.n_transfers, g.n_cache_hits)
    assert stats["torch"] == stats["jax"]
    # One upload of the initial state; every later iteration consumes the
    # previous iteration's device-resident output.
    assert stats["torch"][0] == 1 and stats["torch"][1] >= iters - 1, stats


def test_iterative_swap_with_donated_input_stays_correct():
    """``Program.donate``: the kernel may update its donated inputs in
    place.  Ping-pong chains must stay numerically identical and keep the
    single-upload handoff, with the transfer cache *consuming* donated
    entries."""
    stats = {}
    n, iters = 512, 6
    for name, (core, group) in BACKENDS.items():
        x = np.full(n, float(2 ** iters), np.float32)
        y = np.zeros(n, np.float32)
        g = group("donor")
        prog = core.Program().in_(x).out(y).kernel(halve).work_items(n, 8).donate(0)
        eng = core.EngineCL().use(g).scheduler(core.Static()).program(prog)
        eng.run_iterative(iters, swap=[(0, 0)])
        assert not eng.has_errors(), eng.get_errors()
        np.testing.assert_allclose(np.asarray(prog._ins[0]), 1.0)
        first = (g.n_transfers, g.n_cache_hits)
        # Consumed on hit: no donated entry lingers to be served later.
        eng.run_iterative(iters, swap=[(0, 0)])
        assert not eng.has_errors(), eng.get_errors()
        stats[name] = (first, (g.n_transfers, g.n_cache_hits))
    assert stats["torch"] == stats["jax"]
    (t, h), _ = stats["torch"]
    assert t == 1 and h >= iters - 1, stats


def test_donate_validates_indices():
    p = Program().in_(np.zeros(4, np.float32))
    with pytest.raises(IndexError):
        p.donate(1)
    p.donate(0)
    assert p.donated_ins == (0,)


# ---------------------------------------------------------------- host blocking
def test_pipeline_submission_does_not_host_block():
    """submit_pipeline returns while the chain is still executing."""
    n = 2048
    x = np.ones(n, np.float32)
    progs, w = chain_programs(x, n)
    # ~0.1s of simulated device time per stage.
    g = cpu_group("sim", sim_time_per_wi=5e-5)
    eng = EngineCL().use(g).scheduler(Static())
    t0 = time.perf_counter()
    handles = eng.submit_pipeline(*progs)
    submitted_in = time.perf_counter() - t0
    assert not handles[-1].done()  # chain still in flight on the workers
    assert submitted_in < 0.09  # well under one stage of device time
    assert handles[-1].wait(30)
    handles[-1].result()
    np.testing.assert_allclose(output(progs[-1]), (2.0 * x + 1.0) * 0.5)
    # The graph edges were inferred from the shared buffers.
    assert handles[0] in handles[1].deps and handles[1] in handles[2].deps


# ------------------------------------------------------------------- poisoning
def test_stage_failure_poisons_dependents_without_hanging():
    def boom(offset, a):
        raise RuntimeError("stage1 exploded")

    n = 256
    x = np.ones(n, np.float32)
    progs, w = chain_programs(x, n)
    progs[0].kernel(boom)
    eng = EngineCL().use(cpu_group("a"), cpu_group("b")).scheduler(Dynamic(4))
    handles = eng.submit_pipeline(*progs)
    # Dependents complete (no hang) and report the upstream cause.
    for h in handles:
        assert h.wait(30), "dependent handle hung on a failed upstream run"
    with pytest.raises(RunError, match="stage1 exploded"):
        handles[0].result()
    for h in handles[1:]:
        with pytest.raises(RunError, match="poisoned"):
            h.result()
    # Poisoned stages never executed: their outputs are untouched.
    np.testing.assert_array_equal(output(progs[-1]), 0.0)
    # The blocking wrapper surfaces the whole chain's errors.
    eng.run_pipeline(*[p for p in progs])
    assert eng.has_errors()
    assert any("stage1 exploded" in e for e in eng.get_errors())


def test_explicit_after_poisons_unrelated_program():
    """after= orders runs that share no buffers; upstream failure still
    poisons instead of silently running."""
    def boom(offset, a):
        raise RuntimeError("upstream kaput")

    n = 128
    bad = Program().in_(np.ones(n, np.float32)).out(
        np.zeros(n, np.float32)).kernel(boom).work_items(n, 8)
    good = Program().in_(np.ones(n, np.float32)).out(
        np.zeros(n, np.float32)).kernel(scale2).work_items(n, 8)
    eng = EngineCL().use(cpu_group("g"))
    h1 = eng.submit(bad)
    h2 = eng.submit(good, after=h1)
    assert h2.wait(30)
    with pytest.raises(RunError, match="poisoned"):
        h2.result()


def test_reads_from_links_programs_without_shared_buffers():
    def boom(offset, a):
        raise RuntimeError("producer failed")

    n = 128
    producer = Program().in_(np.ones(n, np.float32)).out(
        np.zeros(n, np.float32)).kernel(boom).work_items(n, 8)
    consumer = Program().in_(np.ones(n, np.float32)).out(
        np.zeros(n, np.float32)).kernel(scale2).work_items(n, 8)
    consumer.reads_from(producer)
    eng = EngineCL().use(cpu_group("g"))
    handles = eng.submit_pipeline(producer, consumer)
    assert handles[0] in handles[1].deps
    with pytest.raises(RunError, match="poisoned"):
        handles[1].result(30)


def test_inplace_program_not_served_stale_slices():
    """A Program using one buffer as both input and output (in-place) must
    not leak pre-write input slices into the cache under the run's write
    version: a dependent reader sees only produced data."""
    n = 1024
    b = torch.ones(n)
    out2 = torch.zeros(n)
    inplace = Program().in_(b).out(b).kernel(scale2).work_items(n, 16)
    reader = Program().in_(b).out(out2).kernel(plus1).work_items(n, 16)
    g = cpu_group("solo")
    # pipeline_depth > 1 so later chunks are sliced after earlier write-backs.
    eng = EngineCL().use(g).scheduler(Dynamic(8))
    eng.run_pipeline(inplace, reader)
    assert not eng.has_errors(), eng.get_errors()
    np.testing.assert_allclose(b.numpy(), 2.0)
    np.testing.assert_allclose(out2.numpy(), 3.0)


def test_iterative_chain_dep_edges_stay_linear():
    """Same-program chains keep one predecessor edge per run (transitive
    ordering), not an edge to every older in-flight run."""
    n, iters = 256, 12
    x = np.full(n, float(2 ** iters), np.float32)
    y = np.zeros(n, np.float32)
    prog = Program().in_(x).out(y).kernel(halve).work_items(n, 8)
    eng = EngineCL().use(cpu_group("solo")).scheduler(Static()).program(prog)
    handles = eng.submit_iterative(iters, swap=[(0, 0)])
    assert all(len(h.deps) <= 1 for h in handles), [len(h.deps) for h in handles]
    for h in handles:
        assert h.wait(30)
        h.result()
    np.testing.assert_allclose(np.asarray(prog._ins[0]), 1.0)


# ------------------------------------------------------- serving decode chains
def test_decode_chain_matches_step_loop():
    """make_decode_chain (device-resident multi-step decode) produces the
    same tokens as the step-at-a-time loop."""
    import dataclasses

    from repro_torch.configs import get_config, reduced
    from repro_torch.models import get_model
    from repro_torch.models.params import materialize
    from repro_torch.serve import (
        make_decode_chain,
        make_decode_step,
        make_prefill_step,
        zeros_cache,
    )

    cfg = dataclasses.replace(reduced(get_config("qwen1.5-4b")), compute_dtype="float32")
    api = get_model(cfg)
    cpu = torch.device("cpu")
    params = materialize(api.param_spec(cfg), torch.Generator().manual_seed(0),
                         torch.float32, cpu)
    b, plen, gen = 4, 8, 4
    tokens = torch.from_numpy(
        np.random.default_rng(1).integers(0, cfg.vocab, (b, plen)).astype(np.int32))
    prefill = make_prefill_step(cfg, api)
    decode = make_decode_step(cfg, api)

    def cache():
        return zeros_cache(cfg, api, b, plen + gen, device=cpu)

    tok, c = prefill(params, {"tokens": tokens}, cache())
    loop = [tok]
    for i in range(gen - 1):
        tok, c = decode(params, c, tok, plen + i)
        loop.append(tok)
    want = torch.cat(loop, dim=1).numpy()

    chain = make_decode_chain(cfg, api)
    tok0, c0 = prefill(params, {"tokens": tokens}, cache())
    toks, last, _ = chain(params, c0, tok0, plen, gen - 1)
    got = torch.cat([tok0, toks], dim=1).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(last.numpy(), want[:, -1:])


# ---------------------------------------------------------- executor lifecycle
def test_submit_after_shutdown_raises_deterministically():
    n = 128
    prog = Program().in_(np.ones(n, np.float32)).out(
        np.zeros(n, np.float32)).kernel(scale2).work_items(n, 8)
    eng = EngineCL().use(cpu_group("g"))
    eng.program(prog).run()
    assert not eng.has_errors()
    rt = eng._runtime
    rt.shutdown()
    with pytest.raises(RuntimeError, match="shut down"):
        rt.executor.submit(rt.groups[0], lambda: None)
    # The engine survives a runtime-level shutdown: _ensure_runtime replaces
    # the dead executor instead of submitting into it.
    eng.run()
    assert not eng.has_errors(), eng.get_errors()
    # And engine.shutdown() itself stays re-entrant.
    eng.shutdown()
    eng.program(prog).run()
    assert not eng.has_errors(), eng.get_errors()
    eng.shutdown()
