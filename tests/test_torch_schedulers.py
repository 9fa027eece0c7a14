"""The port's schedulers (Static, Dynamic, HGuided, adaptive HGuided) vs
the JAX package's: the same package streams (device, offset, size) from the
same geometry, powers and observations, and the system invariant that every
work-group is handed out exactly once."""
import numpy as np
import pytest

try:
    from hypothesis import given, settings
    from hypothesis import strategies as st
except ImportError:  # property tests skip, unit tests still run
    from _hypothesis_stub import given, settings, st

from repro.core import Dynamic as JDynamic
from repro.core import HGuided as JHGuided
from repro.core import Static as JStatic
from repro.core.device import DeviceGroup as JGroup
from repro_torch.core import DeviceGroup, Dynamic, HGuided, Static

SCHEDULERS = {"dynamic": (JDynamic, Dynamic), "hguided": (JHGuided, HGuided),
              "static": (JStatic, Static)}


def tgroup(name, **kw):
    return DeviceGroup(name, device="cpu", **kw)


def drain(sched, total_groups, lws, devices):
    """Pull packages round-robin until exhausted; returns [(dev, off, size)]."""
    sched.prepare(total_groups, lws, devices)
    out = []
    active = list(devices)
    i = 0
    while active:
        d = active[i % len(active)]
        pkg = sched.next_package(d)
        if pkg is None:
            active.remove(d)
            continue
        out.append((d.name, pkg[0], pkg[1]))
        sched.observe(d, pkg[1], 0.01)
        i += 1
    return out


def drain_both(kind, args, total_groups, lws, groups):
    """The same drain on the JAX package's scheduler and the port's, held
    equal; returns the port's packages.  ``groups`` is [(name, kwargs)]."""
    jcls, tcls = SCHEDULERS[kind]
    want = drain(jcls(*args), total_groups, lws, [JGroup(n, **kw) for n, kw in groups])
    got = drain(tcls(*args), total_groups, lws, [tgroup(n, **kw) for n, kw in groups])
    assert got == want
    return got


def check_partition(pkgs, total_wi):
    covered = np.zeros(total_wi, int)
    for _, off, size in pkgs:
        covered[off: off + size] += 1
    assert (covered == 1).all(), "work-items must be covered exactly once"


def powered(powers):
    return [(f"d{i}", {"power": p}) for i, p in enumerate(powers)]


@given(
    total_groups=st.integers(1, 500),
    lws=st.sampled_from([1, 16, 64, 255]),
    powers=st.lists(st.floats(0.1, 16.0), min_size=1, max_size=6),
    n_pkgs=st.integers(1, 64),
)
@settings(max_examples=60, deadline=None)
def test_dynamic_partitions_exactly(total_groups, lws, powers, n_pkgs):
    pkgs = drain_both("dynamic", (n_pkgs,), total_groups, lws, powered(powers))
    check_partition(pkgs, total_groups * lws)


@given(
    total_groups=st.integers(1, 500),
    powers=st.lists(st.floats(0.1, 16.0), min_size=1, max_size=6),
    k=st.floats(1.0, 4.0),
    adaptive=st.booleans(),
)
@settings(max_examples=60, deadline=None)
def test_hguided_partitions_exactly(total_groups, powers, k, adaptive):
    pkgs = drain_both("hguided", (k, adaptive), total_groups, 8, powered(powers))
    check_partition(pkgs, total_groups * 8)


@given(
    total_groups=st.integers(1, 300),
    powers=st.lists(st.floats(0.1, 8.0), min_size=1, max_size=5),
    reverse=st.booleans(),
)
@settings(max_examples=60, deadline=None)
def test_static_partitions_exactly(total_groups, powers, reverse):
    pkgs = drain_both("static", (None, reverse), total_groups, 4, powered(powers))
    check_partition(pkgs, total_groups * 4)
    assert len(pkgs) <= len(powers)  # static: at most one package per device


# The property tests' invariant on fixed draws, so that it is held here
# without hypothesis too.
@pytest.mark.parametrize("kind,args,total_groups,lws,powers", [
    ("dynamic", (1,), 1, 1, (1.0,)),
    ("dynamic", (7,), 500, 16, (0.1, 16.0, 3.0)),
    ("dynamic", (64,), 37, 255, (2.0, 1.0)),
    ("hguided", (2.0, False), 500, 8, (8.0, 1.0, 0.5)),
    ("hguided", (1.0, True), 333, 8, (1.0, 1.0, 1.0, 1.0, 1.0, 1.0)),
    ("hguided", (3.7, True), 1, 8, (0.3,)),
    ("static", (None, False), 300, 4, (0.1, 8.0, 2.5)),
    ("static", (None, True), 7, 4, (1.0, 1.0, 1.0, 1.0, 1.0)),
])
def test_partitions_exactly_fixed_cases(kind, args, total_groups, lws, powers):
    pkgs = drain_both(kind, args, total_groups, lws, powered(powers))
    check_partition(pkgs, total_groups * lws)
    if kind == "static":
        assert len(pkgs) <= len(powers)


def test_static_proportional_shares():
    pkgs = drain_both("static", (), 100, 1, [("a", {"power": 3.0}), ("b", {"power": 1.0})])
    shares = dict((n, s) for n, _, s in pkgs)
    assert shares["a"] == 75 and shares["b"] == 25


def test_static_explicit_props_paper_form():
    # Paper: props for first N-1 devices, remainder to the last.
    pkgs = drain_both("static", ([0.08, 0.3],), 100, 1, [("cpu", {}), ("phi", {}), ("gpu", {})])
    shares = dict((n, s) for n, _, s in pkgs)
    assert shares["cpu"] == 8 and shares["phi"] == 30 and shares["gpu"] == 62


def test_hguided_decreasing_packages():
    pkgs = drain_both("hguided", (2,), 256, 1, [("a", {"power": 1.0})])
    sizes = [s for _, _, s in pkgs]
    assert sizes == sorted(sizes, reverse=True)
    # paper formula: first package = floor(256 * 1 / (2 * 1 * 1)) = 128
    assert sizes[0] == 128


def test_hguided_min_package_scales_with_power():
    got = {}
    for name, cls, group in (("jax", JHGuided, JGroup), ("torch", HGuided, tgroup)):
        fast = group("fast", power=8.0, min_package_groups=4)
        slow = group("slow", power=1.0, min_package_groups=4)
        sched = cls(k=2)
        sched.prepare(1000, 1, [fast, slow])
        got[name] = (sched.next_package(fast), sched.next_package(slow))
    assert got["torch"] == got["jax"]
    f, s = got["torch"]
    assert f[1] > s[1]


def test_hguided_adaptive_rerates():
    got = {}
    for name, cls, group in (("jax", JHGuided, JGroup), ("torch", HGuided, tgroup)):
        fast = group("fast", power=1.0)  # wrong prior: actually fast
        slow = group("slow", power=1.0)
        sched = cls(k=2, adaptive=True)
        sched.prepare(10_000, 1, [fast, slow])
        p1 = sched.next_package(fast)
        sched.observe(fast, p1[1], 0.001)  # very fast
        p2 = sched.next_package(slow)
        sched.observe(slow, p2[1], 1.0)  # very slow
        got[name] = (sched.next_package(fast), sched.next_package(slow))
    assert got["torch"] == got["jax"]
    f2, s2 = got["torch"]
    assert f2[1] > s2[1], "adaptive HGuided must give the fast device bigger packages"


@pytest.mark.parametrize("kind,args", [("dynamic", (17,)), ("hguided", (2.5, True)),
                                       ("static", ([0.2], True))])
def test_clone_keeps_configuration(kind, args):
    """The runtime clones the engine's scheduler for every run: a clone
    must hand out the same packages as its original."""
    _, tcls = SCHEDULERS[kind]
    sched = tcls(*args)
    groups = [tgroup("a", power=2.0), tgroup("b", power=1.0)]
    assert drain(sched.clone(), 100, 4, groups) == drain(sched, 100, 4, groups)
