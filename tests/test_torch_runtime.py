"""The port's EngineCL runtime (Program, DeviceGroup on the CPU, Runtime,
Static) vs the JAX package's on the same geometry: the same outputs, the
same package splits (offset, size per group, from each run's
Introspector), and the same host->device transfer and cache-hit counts,
including ping-pong ``swap_buffers`` chains with donated inputs, linked
pipelines and invalidation.  Plus dependency poisoning as ``RunError`` and
a DeviceGroup that refuses CUDA when the machine has none."""
import numpy as np
import pytest
import torch

from repro import core as jcore
from repro_torch import core as tcore

BACKENDS = {
    "jax": (jcore, lambda a: np.array(a), lambda name, **kw: jcore.DeviceGroup(name, **kw)),
    "torch": (tcore, lambda a: torch.from_numpy(np.array(a)),
              lambda name, **kw: tcore.DeviceGroup(name, device="cpu", **kw)),
}


def as_np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def run_both(scenario):
    """``scenario(core, arr, group)`` on both backends; returns {backend:
    result dict}."""
    return {name: scenario(*fns) for name, fns in BACKENDS.items()}


def packages(handle):
    return sorted((r.device, r.offset_wi, r.size_wi) for r in handle.introspector.records)


def counters(groups):
    return [(g.n_transfers, g.n_cache_hits) for g in groups]


@pytest.mark.parametrize("gws,lws,powers", [
    (100, 4, (2.0, 1.0)),       # Static split by power
    (96, 8, (1.0, 1.0, 2.0)),
    (12, 1, (1.0,)),            # one package of 12, padded to a bucket of 16
    (40, 4, (3.0, 1.0)),        # 10 work-groups: 8 + 2 (8 needs no pad)
])
def test_static_package_splits_and_transfers(gws, lws, powers):
    def scenario(core, arr, group):
        groups = [group(f"g{i}", power=p) for i, p in enumerate(powers)]
        rt = core.Runtime(groups)
        x = arr(np.arange(2 * gws, dtype=np.float32).reshape(gws, 2))
        c = arr(np.full((gws // lws, 3), 0.5, np.float32))  # 1 row per work-group
        y = arr(np.zeros((gws, 2), np.float32))
        prog = (core.Program().in_(x).in_(c).out(y)
                .kernel(lambda off, a, cc: a * 2 + cc[:1, :1].sum(), "k")
                .work_items(gws, lws))
        runs = []
        for _ in range(2):  # the second run hits the cache for both inputs
            h = rt.submit(prog, core.Static())
            h.result()
            runs.append(packages(h))
        rt.shutdown()
        return {"y": as_np(prog.outputs[0]), "runs": runs, "xfer": counters(groups)}

    got = run_both(scenario)
    np.testing.assert_array_equal(got["torch"]["y"], got["jax"]["y"])
    assert got["torch"]["runs"] == got["jax"]["runs"]
    assert got["torch"]["xfer"] == got["jax"]["xfer"]


def test_swap_chain_with_donated_input():
    """An iterative ping-pong chain (after= each previous run, swap epilogue)
    with a donated state: one upload, every later run served the previous
    run's device-resident output — the same counts as the reference."""
    n, iters = 512, 6

    def scenario(core, arr, group):
        g = group("solo")
        rt = core.Runtime([g])
        x = arr(np.full(n, float(2 ** iters), np.float32))
        const = arr(np.linspace(0.5, 0.5, n).astype(np.float32))
        y = arr(np.zeros(n, np.float32))
        prog = (core.Program().in_(x).in_(const).out(y)
                .kernel(lambda off, a, c: a * c, "halve").work_items(n, 8).donate(0))
        prev = None
        for _ in range(iters):
            prev = rt.submit(prog, core.Static(), after=[prev] if prev else None,
                             epilogue=lambda: prog.swap_buffers(0, 0))
        prev.result()
        # External rewrite + invalidate: a fresh upload of the state.
        prog._ins[0][:] = 8.0
        prog.invalidate(prog._ins[0])
        rt.submit(prog, core.Static(), epilogue=lambda: prog.swap_buffers(0, 0)).result()
        rt.shutdown()
        return {"x": as_np(prog._ins[0]), "xfer": counters([g]), "stats": g.transfer_stats()}

    got = run_both(scenario)
    np.testing.assert_array_equal(got["torch"]["x"], got["jax"]["x"])
    np.testing.assert_array_equal(got["torch"]["x"], 4.0)
    assert got["torch"]["xfer"] == got["jax"]["xfer"]
    assert got["torch"]["stats"] == got["jax"]["stats"]
    assert got["torch"]["xfer"][0][0] == 3  # state, const, re-uploaded state


def test_swap_reuses_the_old_input_as_output():
    """swap_buffers copies no contiguous buffer: after each run of a donated
    ping-pong chain the next output is the old input object and the next
    input the old output, as in the reference (``np.ascontiguousarray``).
    The port's kernel updates its donated input in place, as the server's
    segment kernels do, so a device tensor sharing a host buffer's storage
    on the CPU group would corrupt the chain: every run's state and the
    transfer counts must be the reference's."""
    n, iters = 64, 5

    def scenario(core, arr, group):
        g = group("solo")
        rt = core.Runtime([g])
        x = arr(np.arange(n, dtype=np.float32) + 1.0)
        c = arr(np.full(n, 2.0, np.float32))
        y = arr(np.zeros(n, np.float32))
        if core is tcore:
            def kern(off, a, cc):
                return a.mul_(cc)
        else:
            def kern(off, a, cc):
                return a * cc
        prog = core.Program().in_(x).in_(c).out(y).kernel(kern, "double").work_items(n, 8)
        prog.donate(0)
        same, states, prev = [], [], None
        for _ in range(iters):
            old_in, old_out = prog._ins[0], prog._outs[0]
            prev = rt.submit(prog, core.Static(), after=[prev] if prev else None,
                             epilogue=lambda: prog.swap_buffers(0, 0))
            prev.result()
            same.append((prog._ins[0] is old_out, prog._outs[0] is old_in))
            states.append(as_np(prog._ins[0]).copy())
        rt.shutdown()
        return {"same": same, "states": states, "xfer": counters([g])}

    got = run_both(scenario)
    assert got["torch"]["same"] == got["jax"]["same"] == [(True, True)] * iters
    for t, j in zip(got["torch"]["states"], got["jax"]["states"]):
        np.testing.assert_array_equal(t, j)
    np.testing.assert_array_equal(got["torch"]["states"][-1],
                                  (np.arange(n, dtype=np.float32) + 1.0) * 2.0 ** iters)
    assert got["torch"]["xfer"] == got["jax"]["xfer"]


def test_epilogue_span_per_run():
    """The run epilogue is timed: one ``runtime.epilogue`` span per run that
    has one, named by the Program's kernel, on the runtime's track."""
    from repro_torch.core import trace

    g = tcore.DeviceGroup("solo", device="cpu")
    rt = tcore.Runtime([g])
    x, y = torch.ones(8), torch.zeros(8)
    prog = tcore.Program().in_(x).out(y).kernel(lambda o, a: a + 1, "inc").work_items(8, 1)
    prev = trace.set_tracer(trace.Tracer(enabled=True))
    try:
        h = None
        for _ in range(3):
            h = rt.submit(prog, tcore.Static(), after=[h] if h else None,
                          epilogue=lambda: prog.swap_buffers(0, 0))
        h.result()
        rt.submit(prog, tcore.Static()).result()  # no epilogue, no span
        spans = [e for e in trace.tracer().chrome_events()
                 if e.get("ph") == "X" and e["name"] == "runtime.epilogue"]
    finally:
        trace.set_tracer(prev)
        rt.shutdown()
    assert len(spans) == 3
    assert all(e["args"]["kernel"] == "inc" for e in spans)
    np.testing.assert_array_equal(prog._ins[0].numpy(), 4.0)


def test_linked_pipeline_hands_off_device_resident():
    """x -> 2x -> +1 -> /2 through shared host buffers, submitted without
    waiting: only the source is uploaded, the intermediates are served
    still-on-device."""
    n = 1024

    def scenario(core, arr, group):
        g = group("solo")
        rt = core.Runtime([g])
        x = arr(np.arange(n, dtype=np.float32))
        y, z, w = (arr(np.zeros(n, np.float32)) for _ in range(3))
        p1 = core.Program().in_(x).out(y).kernel(lambda o, a: 2.0 * a).work_items(n, 16)
        p2 = core.Program().in_(y).out(z).kernel(lambda o, a: a + 1.0).work_items(n, 16)
        p3 = core.Program().in_(z).out(w).kernel(lambda o, a: a * 0.5).work_items(n, 16)
        hs = [rt.submit(p, core.Static()) for p in (p1, p2, p3)]
        hs[-1].result()
        deps = [len(h.deps) for h in hs]
        rt.shutdown()
        return {"w": as_np(w), "xfer": counters([g]), "deps": deps}

    got = run_both(scenario)
    np.testing.assert_array_equal(got["torch"]["w"], got["jax"]["w"])
    assert got["torch"]["xfer"] == got["jax"]["xfer"] == [(1, 2)]
    assert got["torch"]["deps"] == got["jax"]["deps"] == [0, 1, 1]


def test_failed_run_poisons_dependents():
    def boom(offset, a):
        raise ValueError("kernel failed")

    g = tcore.DeviceGroup("solo", device="cpu")
    rt = tcore.Runtime([g])
    x = torch.ones(8)
    y, z = torch.zeros(8), torch.zeros(8)
    p1 = tcore.Program().in_(x).out(y).kernel(boom, "boom").work_items(8, 1)
    p2 = tcore.Program().in_(y).out(z).kernel(lambda o, a: a, "copy").work_items(8, 1)
    h1, h2 = rt.submit(p1, tcore.Static()), rt.submit(p2, tcore.Static())
    with pytest.raises(tcore.RunError, match="kernel failed"):
        h1.result(timeout=30)
    with pytest.raises(tcore.RunError, match="poisoned: upstream run failed"):
        h2.result(timeout=30)
    assert h2.deps == (h1,)
    # The resident worker survives and serves the next run.
    p3 = tcore.Program().in_(x).out(z).kernel(lambda o, a: a + 1, "inc").work_items(8, 1)
    rt.submit(p3, tcore.Static()).result(timeout=30)
    assert torch.equal(z, torch.full((8,), 2.0))
    rt.shutdown()


def test_validation_failure_completes_with_run_error():
    rt = tcore.Runtime([tcore.DeviceGroup("solo", device="cpu")])
    prog = tcore.Program().in_(torch.ones(8)).out(torch.zeros(8)).work_items(8, 3)
    with pytest.raises(tcore.RunError, match="no kernel set"):
        rt.submit(prog, tcore.Static()).result(timeout=30)
    rt.shutdown()


def test_device_group_refuses_missing_cuda(monkeypatch):
    """The default device is cuda:0; without CUDA the group raises unless
    the CPU was asked for."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tcore.DeviceGroup("serve:0")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tcore.DeviceGroup("serve:0", device="cuda")
    g = tcore.DeviceGroup("serve:0", device="cpu")
    assert g.device == torch.device("cpu") and g.stream is None


def test_bucket_matches_reference():
    for size in range(1, 70):
        for lws in (1, 2, 4, 8):
            assert (tcore.DeviceGroup._bucket(size, lws)
                    == jcore.DeviceGroup._bucket(size, lws))


@pytest.mark.parametrize("weights,total,minimum", [
    ([2.0, 1.0], 8, 1), ([1.0, 1.0, 1.0], 10, 0), ([0.0, 0.0], 5, 1), ([5.0, 1.0, 1.0], 3, 2),
])
def test_proportional_split_matches_reference(weights, total, minimum):
    from repro.serve import multigroup as jmg
    from repro_torch.serve import multigroup as tmg

    got = tmg.proportional_split(weights, total, minimum=minimum)
    assert got == jmg.proportional_split(weights, total, minimum=minimum)
    assert sum(got) == total
    assert tmg.MigrationPolicy().plan({}, {}) == ([], set())
