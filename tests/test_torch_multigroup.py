"""Multi-group serving in the port vs the JAX package: ports of
tests/test_multigroup.py and the slot-splitting case of tests/test_server.py
on reduced qwen1.5-4b (float32, weights materialized in JAX and loaded with
``load_jax_params``, ``kernel_impl="cuda"``: the kernels' plain versions on
the CPU), every group a CPU DeviceGroup.

- Placement math and migration policies (``proportional_split``,
  ``plan_wave``, the schedulers' placement weights, ``RateBalancer``,
  ``ForceMigrate``) equal to the JAX package's on the same seeded inputs.
- ``DeviceGroup.patch_cached``: exactly one transfer for an in-place row
  patch of the stashed device copy, False (the caller invalidates) with no
  full-range stash.
- Forced migration at every coordinated boundary, {contiguous, paged} x
  {plain, spec, chunked}: every stream bitwise the port's batch-1 one-shot
  generate and token-equal to the JAX package's; transfers bounded by
  waves plus migrations, never by segments.
- Elastic drain and join on a live server; slot-splitting co-execution
  under Dynamic and HGuided; the launcher's ``--groups 2 --drain-after``.
- Graph scopes per group: two members of one bucket, pools of one shape,
  replayed through ``CPUReplay`` (a GraphCache that emulates replay on the
  CPU), keep static buffers of their own; a slot-split segment's packages
  on two groups at once too."""
import dataclasses
import threading
import time

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro import configs as jconfigs
from repro import core as jcore
from repro import serve as jserve
from repro.models import get_model as jax_get_model
from repro.models import params as jparams
from repro.serve import multigroup as jmg
from repro_torch import configs as tconfigs
from repro_torch.core import DeviceGroup, Dynamic, HGuided, Program, Runtime, Static
from repro_torch.core.program import buffer_version
from repro_torch.core.rating import placement_weight
from repro_torch.distributed.elastic import ElasticServeGroups
from repro_torch.kernels import _build
from repro_torch.launch import serve as launcher
from repro_torch.models import get_model
from repro_torch.models import params as tparams
from repro_torch.serve import (
    DraftSpec,
    ForceMigrate,
    InferenceServer,
    ModelKernels,
    PagedSpec,
    RateBalancer,
    graphs,
    make_generate,
    plan_wave,
    proportional_split,
)

PLEN = 8


@pytest.fixture(scope="module")
def weights():
    """(JAX config, JAX params, port float32 params on the CPU)."""
    jcfg = jconfigs.reduced(jconfigs.get_config("qwen1.5-4b"))
    jp = jparams.materialize(jax_get_model(jcfg).param_spec(jcfg, 1),
                             jax.random.PRNGKey(0), jnp.float32)
    tcfg = tconfigs.reduced(tconfigs.get_config("qwen1.5-4b"))
    tp = tparams.load_jax_params(jax.tree_util.tree_map(np.asarray, jp), tcfg, "cpu")
    return jcfg, jp, tp


@pytest.fixture(scope="module")
def model(weights):
    """The port's (cfg, api, params): the kernels' plain versions, the
    one-shot reference tiling its cache at the pools' block length."""
    cfg = dataclasses.replace(tconfigs.reduced(tconfigs.get_config("qwen1.5-4b")),
                              kernel_impl="cuda", decode_block=4)
    return cfg, get_model(cfg), weights[2]


@pytest.fixture(scope="module")
def reference(model):
    """The port's one-shot tokens of one prompt at batch 1, memoized."""
    cfg, api, params = model
    gen, memo = make_generate(cfg, api), {}

    def ref(prompt, n):
        key = (prompt.tobytes(), n)
        if key not in memo:
            memo[key] = gen(params, {"tokens": torch.from_numpy(prompt[None])}, n)[0].numpy()
        return memo[key]

    return ref


@pytest.fixture(scope="module")
def jax_reference(weights):
    """The JAX package's one-shot tokens of one prompt at batch 1, memoized."""
    jcfg, jp, _ = weights
    gen, memo = jserve.make_generate(jcfg, jax_get_model(jcfg)), {}

    def ref(prompt, n):
        key = (prompt.tobytes(), n)
        if key not in memo:
            memo[key] = np.asarray(gen(jp, {"tokens": jnp.asarray(prompt[None])}, n))[0]
        return memo[key]

    return ref


def prompts_for(cfg, seed, n, plen=PLEN):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, cfg.vocab, plen).astype(np.int32) for _ in range(n)]


def cpu_groups(*names, **kw):
    return [DeviceGroup(n, device="cpu", **kw) for n in names]


# ----------------------------------------------------------- placement math
def test_proportional_split_units():
    assert proportional_split([1, 1], 4) == [2, 2]
    assert proportional_split([3, 1], 4) == [3, 1]
    # largest-remainder keeps the total exact and every share >= minimum
    assert proportional_split([2, 1, 1], 10, minimum=1) == [4, 3, 3]
    assert proportional_split([0, 0], 4) == [2, 2]  # degenerate: even split
    # total below n * minimum: minimum gives way, total is still honored
    assert sum(proportional_split([1, 1, 1], 2, minimum=1)) == 2
    assert proportional_split([], 4) == []


def test_plan_wave_units():
    assert plan_wave([1, 1], [4, 4], [0, 0], 4) == [2, 2]
    # 3:1 weights -> 3:1 placement once loads even out
    assert plan_wave([3, 1], [4, 4], [0, 0], 4) == [3, 1]
    # capacity is a hard cap; total may fall short of n
    assert plan_wave([1, 1], [1, 0], [0, 0], 3) == [1, 0]
    # pre-existing load steers the wave to the emptier member
    assert plan_wave([1, 1], [4, 4], [3, 0], 2) == [0, 2]
    assert plan_wave([1, 1], [4, 4], [0, 0], 0) == [0, 0]


@pytest.mark.parametrize("seed", range(3))
def test_placement_math_equals_jax(seed):
    """``proportional_split`` and ``plan_wave`` give the JAX package's
    answers on seeded weights, totals, capacities and loads (zero weights,
    empty members and totals below the minimum included)."""
    rng = np.random.default_rng(seed)
    for _ in range(200):
        n = int(rng.integers(0, 5))
        w = (rng.random(n) * rng.integers(0, 3, n)).tolist()
        total, minimum = int(rng.integers(0, 17)), int(rng.integers(0, 3))
        assert proportional_split(w, total, minimum) == jmg.proportional_split(w, total, minimum)
        caps = rng.integers(0, 5, n).tolist()
        loads = rng.integers(0, 5, n).tolist()
        k = int(rng.integers(0, 10))
        assert plan_wave(w, caps, loads, k) == jmg.plan_wave(w, caps, loads, k)


def test_placement_weights_rates_and_watts():
    a, b = DeviceGroup("a", device="cpu", power=2.0), DeviceGroup("b", device="cpu", power=1.0)
    dyn = Dynamic(2)
    w = dyn.placement_weights([a, b])
    assert w[0] / w[1] == pytest.approx(2.0)        # cold: rated power
    w = dyn.placement_weights([a, b], {"a": 10.0, "b": 30.0})
    assert w[1] / w[0] == pytest.approx(3.0)        # observed rates win
    stat = Static().placement_weights([a, b], {"a": 10.0, "b": 30.0})
    assert stat[0] / stat[1] == pytest.approx(2.0)  # Static ignores rates
    c = DeviceGroup("c", device="cpu", power=1.0, watts=2.0)
    w = dyn.placement_weights([b, c], {"b": 30.0, "c": 30.0})
    assert w[0] / w[1] == pytest.approx(2.0)        # tokens/joule rating
    assert placement_weight(0.0, power=4.0) == 4.0
    assert placement_weight(30.0, watts=3.0) == 10.0
    assert not Static().rebalances()
    assert Dynamic(2).rebalances() and HGuided().rebalances()


@pytest.mark.parametrize("kind", ["static", "dynamic", "hguided"])
def test_placement_weights_equal_jax(kind):
    """Each scheduler's placement weights equal the JAX package's for
    seeded powers, watts and observed rates (cold groups included)."""
    make = {"static": (Static, jcore.Static), "dynamic": (lambda: Dynamic(2),
                                                         lambda: jcore.Dynamic(2)),
            "hguided": (HGuided, jcore.HGuided)}[kind]
    rng = np.random.default_rng(5)
    for _ in range(20):
        n = int(rng.integers(1, 4))
        powers = (rng.random(n) * 3 + 0.1).tolist()
        watts = (rng.integers(0, 2, n) * rng.random(n) * 300).tolist()
        names = [f"g{i}" for i in range(n)]
        tg = [DeviceGroup(nm, device="cpu", power=p, watts=wt)
              for nm, p, wt in zip(names, powers, watts)]
        jg = [jcore.DeviceGroup(nm, power=p, watts=wt) for nm, p, wt in zip(names, powers, watts)]
        rates = {nm: float(rng.random() * 50) for nm in names if rng.random() < 0.7}
        assert make[0]().placement_weights(tg, rates) == pytest.approx(
            make[1]().placement_weights(jg, rates), rel=1e-12)
        assert make[0]().rebalances() == make[1]().rebalances()


# -------------------------------------------------------- migration policies
class _FakeMember:
    def __init__(self, active, boundary=True, accept=True, n_slots=4):
        self.slots = [object() if i < active else None for i in range(n_slots)]
        self._b, self._a = boundary, accept

    def at_boundary(self):
        return self._b

    def can_accept_migration(self, src, slot):
        return self._a


def test_rate_balancer_moves_overshare_to_undershare():
    m = {"a": _FakeMember(4), "b": _FakeMember(0)}
    moves, hold = RateBalancer().plan(m, {"a": 1.0, "b": 1.0})
    assert moves == [("a", 0, "b")] and not hold
    # within one slot of the proportional share: leave it alone
    m = {"a": _FakeMember(2), "b": _FakeMember(1)}
    assert RateBalancer().plan(m, {"a": 2.0, "b": 1.0})[0] == []
    # opportunistic only: a mid-segment source is never held
    m = {"a": _FakeMember(4, boundary=False), "b": _FakeMember(0)}
    moves, hold = RateBalancer().plan(m, {"a": 1.0, "b": 1.0})
    assert moves == [] and not hold
    # destination refuses (e.g. pool too full): no move
    m = {"a": _FakeMember(4), "b": _FakeMember(0, accept=False)}
    assert RateBalancer().plan(m, {"a": 1.0, "b": 1.0})[0] == []


def test_force_migrate_holds_until_common_boundary():
    fm = ForceMigrate()
    m = {"a": _FakeMember(2), "b": _FakeMember(1, boundary=False)}
    moves, hold = fm.plan(m, {})
    assert moves == [] and hold == {"a"}  # a waits at its boundary
    m = {"a": _FakeMember(2), "b": _FakeMember(1)}
    moves, hold = fm.plan(m, {})
    assert moves == [("a", 0, "b")] and not hold
    assert fm.moves_planned == 1
    assert fm.plan({"a": _FakeMember(2)}, {}) == ([], set())  # needs two


@pytest.mark.parametrize("policy", ["rate", "force"])
def test_policies_equal_jax(policy):
    """``RateBalancer`` and ``ForceMigrate`` plan the JAX package's moves,
    holds and journal inputs on seeded member states."""
    rng = np.random.default_rng(11)
    tp, jp = ((RateBalancer(), jmg.RateBalancer()) if policy == "rate"
              else (ForceMigrate(), jmg.ForceMigrate()))
    for _ in range(300):
        n = int(rng.integers(1, 4))
        spec = [(int(rng.integers(0, 5)), bool(rng.random() < 0.8), bool(rng.random() < 0.8))
                for _ in range(n)]
        members = {f"m{i}": _FakeMember(a, b, c) for i, (a, b, c) in enumerate(spec)}
        weights = {nm: float(rng.random() * 3) for nm in members if rng.random() < 0.8}
        assert tp.plan(members, weights) == jp.plan(members, weights)
        assert tp.last_info == jp.last_info
    if policy == "force":
        assert tp.moves_planned == jp.moves_planned > 0


# ------------------------------------------------- O(rows) patch accounting
def test_patch_cached_exact_transfer_accounting():
    """patch_cached rewrites rows of the device-resident copy in place for
    exactly one counted transfer — the O(blocks) migration primitive — and
    refuses when no full-range stash exists or the buffer is an output
    (the caller falls back to invalidate)."""
    g = DeviceGroup("patch", device="cpu")
    x = torch.arange(12, dtype=torch.float32).reshape(4, 3)
    out = torch.zeros((4, 3))
    prog = Program().in_(x).out(out).kernel(lambda o, a: a, "copy").work_items(4, 1)
    ver = buffer_version(x)
    stash = x.clone()
    g.stash_output(prog, x, 0, 4, stash, ver)
    g.stash_output(prog, x, 0, 2, stash[:2].clone(), ver)  # a partial entry
    t0 = g.n_transfers
    x[2] = 9.0  # host mirror first; device patch follows
    assert g.patch_cached(prog, x, [2], x[2:3].clone())
    assert g.n_transfers == t0 + 1  # exactly one O(rows) upload
    base = g._xfer_cache[(id(x), ver, 0, 4, 0)]
    assert base.data_ptr() == stash.data_ptr() and torch.equal(stash, x)  # in place
    assert [k for k in g._xfer_cache if k[0] == id(x)] == [(id(x), ver, 0, 4, 0)]
    y = torch.zeros((4, 3))
    prog2 = Program().in_(y).out(torch.zeros((4, 3))).kernel(lambda o, a: a, "copy")
    assert not g.patch_cached(prog2.work_items(4, 1), y, [0], y[:1].clone())  # no stash
    g.stash_output(prog, out, 0, 4, out.clone(), buffer_version(out))
    assert not g.patch_cached(prog, out, [0], out[:1].clone())  # a Program output
    assert g.n_transfers == t0 + 1
    assert (g.n_patches, g.n_patch_misses) == (1, 2)


# --------------------------------------------- forced-migration bit identity
@pytest.mark.parametrize("mode", ["plain", "spec", "chunked"])
@pytest.mark.parametrize("paged", [False, True], ids=["contiguous", "paged"])
def test_forced_migration_sweep_bitwise(model, reference, jax_reference, paged, mode):
    """Two groups with a migration forced at every coordinated segment
    boundary: slots hop between groups (block handoff under paged, row
    handoff under contiguous) across plain, speculative and chunked decode;
    every stream equals the port's batch-1 one-shot bitwise and the JAX
    package's tokens."""
    cfg, api, params = model
    policy = ForceMigrate()
    kw = {}
    if mode == "spec":
        kw["draft"] = DraftSpec(cfg, params, k=2)
    if mode == "chunked":
        kw["chunk_len"] = 4
    prompts = prompts_for(cfg, 71, 6)
    gens = [8, 5, 8, 6, 8, 5]
    with InferenceServer(cfg, api, params, groups=cpu_groups("mga", "mgb"),
                         scheduler=Static(), group_batches=True, migration=policy,
                         buckets=(PLEN,), max_batch=4, seg_len=2, max_new_cap=14,
                         max_wait_ms=5.0, paged=PagedSpec(block_len=4) if paged else None,
                         **kw) as srv:
        handles = [srv.submit(p, n) for p, n in zip(prompts, gens)]
        results = [h.result(timeout=300) for h in handles]
        s = srv.stats()
    for p, n, got in zip(prompts, gens, results):
        np.testing.assert_array_equal(got, reference(p, n))
        np.testing.assert_array_equal(got, jax_reference(p, n))
    assert s["completed"] == 6
    assert s["slot_migrations"] >= 1, s
    assert policy.moves_planned >= 1
    per = s["placement"]["per_group"]
    assert sum(d["migrations_in"] for d in per.values()) == s["slot_migrations"]
    assert sum(d["segments"] for d in per.values()) == s["segments"]
    kinds = [r["reason"] for r in s["decisions"]["recent"] if r["kind"] == "migration"]
    assert kinds == [] or set(kinds) == {"ForceMigrate"}  # journal off without the tracer


def test_migration_transfers_scale_with_moves_not_segments(model, reference):
    """Migrations pay O(rows + blocks) through patch_cached, never a
    per-segment or full-cache re-upload: total transfers stay bounded by
    prefill waves + migrations while decode runs many more segments."""
    cfg, api, params = model
    policy = ForceMigrate()
    ga, gb = cpu_groups("xfa", "xfb")
    prompts = prompts_for(cfg, 81, 4)
    gens = [10, 3, 10, 3]  # short streams free the slots migrations need
    with InferenceServer(cfg, api, params, groups=[ga, gb], scheduler=Static(),
                         group_batches=True, migration=policy, buckets=(PLEN,), max_batch=4,
                         seg_len=2, max_new_cap=12, max_wait_ms=5.0,
                         paged=PagedSpec(block_len=4)) as srv:
        handles = [srv.submit(p, n) for p, n in zip(prompts, gens)]
        for p, n, h in zip(prompts, gens, handles):
            np.testing.assert_array_equal(h.result(timeout=300), reference(p, n))
        s = srv.stats()
        n_leaves = len(srv.kernels.bax_leaves)
    migs = s["slot_migrations"]
    assert migs >= 1, s
    # decode really was multi-segment far beyond the join/migration events
    assert s["segments"] > s["prefill_waves"] + migs, s
    # per wave: prompt upload + segment-input re-upload; per migration: at
    # most one patch per control row / pool leaf / table, or one fallback
    # re-upload of the inputs.  Nothing scales with segment count.
    n_ins = 3 + n_leaves  # tok, pos, table, pool leaves
    budget = (s["prefill_waves"] + migs + 1) * (1 + 2 * n_ins)
    total = ga.n_transfers + gb.n_transfers
    assert total <= budget, (total, budget, s)
    # Most migrated rows land in place on the destination's device copy.
    patches = s["placement"]["patches"]
    assert sum(p["patched"] for p in patches.values()) >= migs


# ------------------------------------------------------------ elastic serve
def test_elastic_drain_and_join_on_live_server(model, reference):
    """Mid-replay scale-down then scale-up through ElasticServeGroups: the
    drained group's slots migrate to survivors (streams bitwise), the last
    active group refuses to drain, an unknown group is refused, and a
    freshly joined group serves new requests on the same live server."""
    cfg, api, params = model
    prompts = prompts_for(cfg, 91, 6)
    gens = [10, 4, 10, 4, 10, 4]
    with InferenceServer(cfg, api, params, groups=cpu_groups("ela", "elb"),
                         scheduler=HGuided(), group_batches=True, buckets=(PLEN,),
                         max_batch=4, seg_len=2, max_new_cap=12, max_wait_ms=5.0,
                         paged=PagedSpec(block_len=4)) as srv:
        ctl = ElasticServeGroups(srv)
        handles = [srv.submit(p, n) for p, n in zip(prompts, gens)]
        deadline = time.monotonic() + 120
        while srv.stats()["segments"] < 1:
            assert time.monotonic() < deadline, "decode never started"
            time.sleep(0.005)
        ctl.drain("elb")
        assert "elb" in srv.stats()["placement"]["draining"]
        with pytest.raises(ValueError, match="only active group"):
            ctl.drain("ela")
        with pytest.raises(ValueError, match="unknown group"):
            ctl.drain("nope")
        for p, n, h in zip(prompts, gens, handles):
            np.testing.assert_array_equal(h.result(timeout=300), reference(p, n))
        # scale back up: a new group joins the live runtime and serves
        ctl.join(DeviceGroup("elc", device="cpu"))
        assert "elc" in srv.stats()["placement"]["member_slots"]
        h2 = [srv.submit(p, 4) for p in prompts[:4]]
        for p, h in zip(prompts, h2):
            np.testing.assert_array_equal(h.result(timeout=300), reference(p, 4))
        s = srv.stats()
    assert s["completed"] == 10
    assert s["placement"]["per_group"]["elc"]["prefill_waves"] >= 1


def test_elastic_requires_group_batches(model):
    cfg, api, params = model
    with InferenceServer(cfg, api, params, groups=cpu_groups("one"), buckets=(PLEN,)) as srv:
        with pytest.raises(RuntimeError, match="group_batches"):
            srv.drain_group("one")
        with pytest.raises(RuntimeError, match="group_batches"):
            srv.join_group(DeviceGroup("two", device="cpu"))


# ------------------------------------------------ slot-splitting co-execution
@pytest.mark.parametrize("kind", ["dynamic", "hguided"])
def test_coexec_slot_splitting_stays_bitwise(model, reference, kind):
    """Two device groups + an adaptive scheduler without group_batches:
    each segment's slot axis is split across the groups (varying splits),
    streams unchanged."""
    cfg, api, params = model
    prompts = prompts_for(cfg, 31, 6)
    sched = Dynamic(2) if kind == "dynamic" else HGuided()
    groups = cpu_groups("pod-a", "pod-b")
    with InferenceServer(cfg, api, params, groups=groups, scheduler=sched, buckets=(PLEN,),
                         max_batch=4, seg_len=2, max_new_cap=8, max_wait_ms=5.0) as srv:
        assert not srv.group_batches
        handles = [srv.submit(p, 6) for p in prompts]
        for p, h in zip(prompts, handles):
            np.testing.assert_array_equal(h.result(timeout=300), reference(p, 6))
        assert srv.stats()["completed"] == 6
    assert all(g.n_transfers > 0 for g in groups)  # both groups ran packages


# ---------------------------------------------------- graph scopes per group
class CPUReplay(graphs.GraphCache):
    """A GraphCache that "captures" on the CPU: the loop runs once on clones
    of its static buffers (for its outputs and launch tally), and a replay
    reruns it on the static buffers themselves, uncounted, copying its
    results into the captured outputs, as a CUDA graph writes its own."""

    @staticmethod
    def accepts(device):
        return True

    def _record(self, statics, body):
        outputs = body(graphs._rebuild(statics, lambda r, i, s: s.clone()))

        class Replay:
            @staticmethod
            def replay():
                with _build.recording():
                    results = body(statics)
                for o, r in zip(outputs, results):
                    o.copy_(r)

        return Replay(), outputs, {}


def _replayed_server(cfg, api, params, groups, prompts, gens, **kw):
    kernels = ModelKernels(cfg, api, params)
    kernels.graphs = CPUReplay()
    for g in groups:
        g.graphs = CPUReplay()  # the prefill waves' graphs
    with InferenceServer(cfg, api, params, groups=groups, buckets=(PLEN,), max_new_cap=16,
                         seg_len=2, max_wait_ms=5.0, kernels=kernels, **kw) as srv:
        handles = [srv.submit(p, n) for p, n in zip(prompts, gens)]
        results = [h.result(timeout=300) for h in handles]
        stats = srv.stats()
    return results, stats, kernels


def test_two_members_of_one_bucket_keep_their_pools(model, reference):
    """Two groups' members of one bucket, pools of one shape (equal powers,
    a fixed block count), replayed through CPUReplay: each member's loops
    take static buffers of their own scope, (bucket, group), and every
    stream, across forced migrations, is bitwise one-shot generate's.  A
    scope of the bucket alone would hand one member's pool to the other's
    next segment."""
    cfg, api, params = model
    prompts = prompts_for(cfg, 41, 6)
    gens = [9, 5, 9, 7, 9, 6]
    groups = cpu_groups("sca", "scb")
    results, s, kernels = _replayed_server(
        cfg, api, params, groups, prompts, gens, scheduler=Static(), group_batches=True,
        migration=ForceMigrate(), max_batch=4, paged=PagedSpec(block_len=4, n_blocks=24))
    for p, n, r in zip(prompts, gens, results):
        np.testing.assert_array_equal(r, reference(p, n))
    assert s["slot_migrations"] >= 1
    assert all(d["segments"] >= 1 for d in s["placement"]["per_group"].values())
    g = s["graphs"]
    assert g["replays"] == s["segments"] and g["captures"] == 2  # one loop a member
    assert g["warmup_clone_bytes"] == 0
    pools = {}
    for (scope, role, i, shape, _, _), buf in kernels.graphs._buffers.items():
        if role == "cache":
            pools.setdefault(i, {})[scope] = (shape, buf.data_ptr())
    for by_scope in pools.values():
        assert set(by_scope) == {(PLEN, "sca"), (PLEN, "scb")}
        a, b = by_scope[(PLEN, "sca")], by_scope[(PLEN, "scb")]
        assert a[0] == b[0] and a[1] != b[1]


def test_slot_split_packages_replay_in_their_groups_scopes(model, reference):
    """One batch slot-split across two groups under Dynamic, one slot a
    package, its segment loops replayed through CPUReplay: each group's
    packages bind buffers of its own scope (the two run at once on their
    worker threads), and a group's second package of a segment replays the
    same graph before the first's write-back, so the replays' outputs are
    copied out of the graph's memory; every stream is bitwise one-shot
    generate's."""
    cfg, api, params = model
    prompts = prompts_for(cfg, 51, 6)
    gens = [7, 5, 7, 6, 7, 5]
    groups = cpu_groups("ssa", "ssb")
    results, s, kernels = _replayed_server(cfg, api, params, groups, prompts, gens,
                                           scheduler=Dynamic(4), max_batch=4)
    for p, n, r in zip(prompts, gens, results):
        np.testing.assert_array_equal(r, reference(p, n))
    g = s["graphs"]
    assert g["replays"] >= s["segments"] and g["output_copies"] == 3 * g["replays"]
    scopes = {scope for (scope, *_), _ in kernels.graphs._buffers.items()}
    assert scopes == {(PLEN, "ssa"), (PLEN, "ssb")}


def test_segment_loop_capture_wait_is_not_service_time():
    """A group's package that captures a loop of a cache outside the group
    (a server's segment loop) while another thread holds the capture lock:
    the wait is credited to the group (``capture_wait_s``), and the service
    time its scheduler observes leaves it out."""
    cache = CPUReplay()

    def kern(offset, x):
        loop = graphs.bind(cache, "double", 1, (), {"tok": x}, lambda st, n: (st["tok"] * 2,),
                           scope=("loop", offset))
        return loop()[0]

    graphs.passthrough(kern)
    group = DeviceGroup("lw", device="cpu")
    observed = []

    class Observing(Static):
        def observe(self, g, size, seconds):
            observed.append(seconds)
            super().observe(g, size, seconds)

        def clone(self):
            return self

    x, y = torch.arange(4, dtype=torch.float32), torch.zeros(4)
    prog = Program().in_(x).out(y).kernel(kern, "double").work_items(4, 4)
    held = threading.Event()

    def hold():
        with graphs._CAPTURE_LOCK:
            held.set()
            time.sleep(0.3)

    holder = threading.Thread(target=hold)
    holder.start()
    held.wait()
    rt = Runtime([group])
    try:
        t0 = time.perf_counter()
        rt.submit(prog, Observing()).result()
        wall = time.perf_counter() - t0
    finally:
        rt.shutdown()
        holder.join()
    torch.testing.assert_close(y, 2 * x, rtol=0, atol=0)
    assert group.graphs is None and group.loop_wait_s >= 0.25
    assert group.capture_wait_s == group.loop_wait_s == cache.wait_s
    assert len(observed) == 1 and observed[0] <= wall - group.loop_wait_s


# ------------------------------------------------------------------ launcher
def test_launcher_groups_drain_verify(capsys):
    """``--server --paged --groups 2 --drain-after 4 --verify`` on the CPU:
    pod-b drains after the fourth submission, every stream bitwise one-shot
    generate's."""
    result = launcher.main(["--arch", "qwen1.5-4b", "--server", "--paged", "--groups", "2",
                            "--scheduler", "hguided", "--drain-after", "4", "--verify",
                            "--device", "cpu", "--requests", "8", "--gen", "6"])
    out = capsys.readouterr().out
    assert "multi-group: slots={'pod-a': " in out and "drained=pod-b" in out
    assert "verify: 8 results bit-identical to one-shot generate" in out
    assert result["drained"] == "pod-b" and set(result["groups"]) == {"pod-a", "pod-b"}
    assert result["stats"]["placement"]["draining"] == ["pod-b"]
