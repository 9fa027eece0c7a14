"""The decode loops as CUDA graphs (``serve/graphs.py``), on the CPU.

A CPU tensor runs every loop eagerly, so here the graph machinery is held
apart from the card:
- the chain with a tensor ``pos`` (what one graph needs to serve every start
  position) against the JAX package's jitted chain at two start positions,
  on reduced qwen1.5-4b, falcon-mamba-7b and recurrentgemma-2b: tokens
  equal, caches within the parity suites' float32 1e-4;
- ``make_generate(graph=True)`` bitwise ``graph=False`` and equal to the
  JAX package's ``make_generate``;
- the cache key (never an input's address), the launch tally of a
  recording, and the ``generate.prefill``/``generate.chain`` spans against
  the JAX package's;
- ``CPUReplay``, a GraphCache whose "graph" reruns the captured loop on its
  static buffers and writes the same output tensors each replay, as a CUDA
  graph does: through it one-shot prefill and its chain, the server's
  loops (plain, contiguous and paged, the mixed loops with and without
  their chunk stage, the speculative scan and its bypass, each with and
  without a chunk stage) and a DeviceGroup's compiled kernels (the prefill
  waves, co-execution's packages) use the static buffers, copy-ins and
  write-backs exactly as on the card, and must give the eager streams
  bitwise; two prefill waves of one shape keep the first's handed-off
  leaves; no capture warms up on clones of a live cache; a compiled
  kernel's scalar arguments are device scalars (one graph for every
  value); a capture's wait for another thread's capture is left out of the
  service time the scheduler observes.
"""
import dataclasses
import threading
import time

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro import configs as jconfigs
from repro import serve as jserve
from repro.core import trace as jtrace
from repro.models import get_model as jax_get_model
from repro.models import params as jparams
from repro_torch import configs as tconfigs
from repro_torch import core as tcore
from repro_torch.core import DeviceGroup
from repro_torch.core import trace as ttrace
from repro_torch.kernels import _build
from repro_torch.models import get_model
from repro_torch.models import params as tparams
from repro_torch.serve import (
    DraftSpec,
    InferenceServer,
    ModelKernels,
    PagedSpec,
    graphs,
    make_decode_chain,
    make_generate,
    make_prefill_step,
    zeros_cache,
)
from repro_torch.serve import step as tstep

TOL = 1e-4
ARCHS = ["qwen1.5-4b", "falcon-mamba-7b", "recurrentgemma-2b"]
# The port's "cuda" (the kernels' plain versions here) against the JAX
# "reference" for the dense model, "pallas_interpret" for the recurrent ones.
JAX_IMPL = {"qwen1.5-4b": "reference", "falcon-mamba-7b": "pallas_interpret",
            "recurrentgemma-2b": "pallas_interpret"}


class CPUReplay(graphs.GraphCache):
    """A GraphCache that "captures" on the CPU: the loop runs once on clones
    of its static buffers (for its outputs and launch tally), and a replay
    reruns it on the static buffers themselves, uncounted, copying its
    results into the captured outputs."""

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


def _weights(arch, seed=0):
    jcfg = dataclasses.replace(jconfigs.reduced(jconfigs.get_config(arch)),
                               kernel_impl=JAX_IMPL[arch])
    tcfg = dataclasses.replace(tconfigs.reduced(tconfigs.get_config(arch)), kernel_impl="cuda")
    japi = jax_get_model(jcfg)
    jp = jparams.materialize(japi.param_spec(jcfg, 1), jax.random.PRNGKey(seed), jnp.float32)
    tp = tparams.load_jax_params(jax.tree_util.tree_map(np.asarray, jp), tcfg, "cpu")
    return jcfg, japi, jp, tcfg, get_model(tcfg), tp


@pytest.fixture(scope="module", params=ARCHS)
def model(request):
    return _weights(request.param)


def _replay_chain(cfg, api, monkeypatch):
    monkeypatch.setattr(tstep, "GraphCache", CPUReplay)
    return make_decode_chain(cfg, api, graph=True)


def test_chain_tensor_pos_matches_jax(model, monkeypatch):
    """Two chains back to back, the second from where the first ended, each
    started by a device int32 tensor: tokens equal the JAX jitted chain's
    (started by jnp.int32), caches within 1e-4; the replayed chain is
    bitwise the eager one, and its second start position replays the first
    start's graph."""
    jcfg, japi, jp, tcfg, tapi, tp = model
    b, s, n = 2, 6, 4  # 6 + 8 positions: recurrentgemma's ring of 8 wraps
    prompts = np.random.default_rng(3).integers(0, tcfg.vocab, (b, s)).astype(np.int32)
    jchain = jax.jit(jserve.make_decode_chain(jcfg, japi), static_argnums=(4,))
    jtok, jcache = jax.jit(jserve.make_prefill_step(jcfg, japi))(
        jp, {"tokens": jnp.asarray(prompts)}, jserve.zeros_cache(jcfg, japi, b, s + 2 * n))
    prefill = make_prefill_step(tcfg, tapi)
    runs = {}
    for name, chain in (("eager", make_decode_chain(tcfg, tapi)),
                        ("replay", _replay_chain(tcfg, tapi, monkeypatch))):
        tok, cache = prefill(tp, {"tokens": torch.from_numpy(prompts)},
                             zeros_cache(tcfg, tapi, b, s + 2 * n, device="cpu"))
        np.testing.assert_array_equal(tok.numpy(), np.asarray(jtok))
        toks, copies = [], []
        for start in (s, s + n):
            t, tok, cache = chain(tp, cache, tok, torch.tensor(start, dtype=torch.int32), n)
            toks.append(t.numpy())
            if name == "replay":
                copies.append(chain.graphs.copy_ins - sum(copies))
        runs[name] = (np.concatenate(toks, axis=1), cache)
        if name == "replay":
            st = chain.graphs.stats()
            assert (st["captures"], st["replays"]) == (1, 2)
            # The second chain takes the first's returned (static) cache:
            # only the token and the start position are copied in.
            assert copies == [2 + len(tparams.tree_leaves(cache)), 2]
    want, jt = [], jtok
    for start in (s, s + n):
        t, jt, jcache = jchain(jp, jcache, jt, jnp.int32(start), n)
        want.append(np.asarray(t))
    want = np.concatenate(want, axis=1)
    np.testing.assert_array_equal(runs["eager"][0], want)
    np.testing.assert_array_equal(runs["replay"][0], runs["eager"][0])
    jleaves = jax.tree_util.tree_leaves(jcache)
    for name, (_, cache) in runs.items():
        tleaves = tparams.tree_leaves(cache)
        assert len(tleaves) == len(jleaves)
        for t, j in zip(tleaves, jleaves):
            assert tuple(t.shape) == tuple(j.shape)
            np.testing.assert_allclose(t.float().numpy(), np.asarray(j, np.float32),
                                       atol=TOL, rtol=TOL)
    for t, e in zip(tparams.tree_leaves(runs["replay"][1]), tparams.tree_leaves(runs["eager"][1])):
        assert torch.equal(t, e)


def test_generate_graph_matches_eager_and_jax(model, monkeypatch):
    """make_generate(graph=True) on CPU tensors is bitwise graph=False and
    equal to the JAX package's make_generate; through CPUReplay too, where
    prefill and the chain replay a graph each, a second call of the same
    shape captures nothing, and a call copies in the prompt tokens only
    (the prefill graph writes the chain's static cache, token and start
    position in place)."""
    jcfg, japi, jp, tcfg, tapi, tp = model
    prompts = np.random.default_rng(4).integers(0, tcfg.vocab, (3, 7)).astype(np.int32)
    gen = 5
    batch = {"tokens": torch.from_numpy(prompts)}
    want = np.asarray(jserve.make_generate(jcfg, japi)(jp, {"tokens": jnp.asarray(prompts)},
                                                       gen))
    eager = make_generate(tcfg, tapi, graph=False)(tp, batch, gen).numpy()
    graphed = make_generate(tcfg, tapi, graph=True)
    assert graphed.prepare(tp, batch, gen) == 0.0  # CPU tensors: nothing captured
    np.testing.assert_array_equal(eager, want)
    np.testing.assert_array_equal(graphed(tp, batch, gen).numpy(), eager)
    monkeypatch.setattr(tstep, "GraphCache", CPUReplay)
    replayed = make_generate(tcfg, tapi)
    assert replayed.prepare(tp, batch, gen) > 0.0
    copies = []
    for _ in range(2):
        np.testing.assert_array_equal(replayed(tp, batch, gen).numpy(), eager)
        copies.append(replayed.graphs.copy_ins - sum(copies))
    st = replayed.graphs.stats()
    assert (st["captures"], st["replays"]) == (2, 4)
    assert {n: d["captures"] for n, d in st["loops"].items()} == {"prefill": 1,
                                                                 "decode_chain": 1}
    # Each call copies in the prompt tokens only.
    assert copies == [1, 1]
    # Another batch is another shape; the first shape's graphs stay, and
    # the new shape's captures find no live buffer of the first's.
    np.testing.assert_array_equal(replayed(tp, {"tokens": batch["tokens"][:1]}, gen).numpy(),
                                  eager[:1])
    st = replayed.graphs.stats()
    assert st["captures"] == 4 and st["warmup_clone_bytes"] == 0


def test_graph_key_ignores_addresses():
    """Two fresh caches of one shape give one key; a new step count, static
    int (k), batch, scope or weights gives another."""
    def inputs(b, s=10):
        return {"tok": torch.zeros((b, 1), dtype=torch.int32),
                "cache": [torch.zeros((2, b, s, 4)), torch.full((2, b, s), -1, dtype=torch.int32)]}

    params = {"w": torch.ones(3)}
    key = graphs.GraphCache.key
    a = key("decode", 8, (2, 256), inputs(4), (params,), 16)
    assert a == key("decode", 8, (2, 256), inputs(4), (params,), 16)
    assert a != key("decode", 4, (2, 256), inputs(4), (params,), 16)   # seg_len
    assert a != key("decode", 8, (4, 256), inputs(4), (params,), 16)   # k
    assert a != key("decode", 8, (2, 256), inputs(2), (params,), 16)   # batch
    assert a != key("decode", 8, (2, 256), inputs(4, 12), (params,), 16)  # cache length
    assert a != key("decode", 8, (2, 256), inputs(4), ({"w": torch.ones(3)},), 16)  # weights
    assert a != key("decode", 8, (2, 256), inputs(4), (params,), 32)   # scope
    assert a != key("spec", 8, (2, 256), inputs(4), (params,), 16)
    with pytest.raises(ValueError, match="one device"):
        key("decode", 8, (), {"tok": torch.zeros(1), "x": torch.zeros(1, device="meta")})
    # Static buffers are shared by role and shape within a scope, whatever
    # the loop, and never across scopes.
    gc = graphs.GraphCache()
    st = gc.statics(inputs(4), scope=16)
    assert gc.statics(inputs(4), scope=16)["cache"][0] is st["cache"][0]
    assert gc.statics(inputs(2), scope=16)["cache"][0] is not st["cache"][0]
    assert gc.statics(inputs(4), scope=32)["cache"][0] is not st["cache"][0]


def test_recording_tally_counts_per_replay():
    """count() inside a recording adds nothing to LAUNCHES or MULTI_ROW; each
    replay of the tally adds it once; another thread counts as before."""
    _build.reset_launches()
    with _build.recording() as tally:
        _build.count("gemm_rowinv")
        _build.count("gemm_rowinv")
        _build.count("flash_decode", multi_row=True)
        t = threading.Thread(target=_build.count, args=("rms_norm",))
        t.start()
        t.join()
    assert _build.LAUNCHES["gemm_rowinv"] == 0 and _build.MULTI_ROW["flash_decode"] == 0
    assert _build.LAUNCHES["rms_norm"] == 1
    for n in (1, 2, 3):
        tally.replayed()
        assert _build.LAUNCHES["gemm_rowinv"] == 2 * n
        assert _build.LAUNCHES["flash_decode"] == n and _build.MULTI_ROW["flash_decode"] == n
    with _build.recording():
        with _build.recording() as inner:
            _build.count("ssm_scan")
        _build.count("rglru_scan")
    assert inner.launches == {"ssm_scan": 1}
    assert _build.LAUNCHES["ssm_scan"] == 0 and _build.LAUNCHES["rglru_scan"] == 0
    _build.reset_launches()


def test_generate_spans_match_jax():
    """generate.prefill (batch, seq) and generate.chain (steps), as the JAX
    package's make_generate records them."""
    jcfg, japi, jp, tcfg, tapi, tp = _weights("qwen1.5-4b")
    prompts = np.random.default_rng(5).integers(0, tcfg.vocab, (2, 5)).astype(np.int32)

    def spans(module, run):
        prev = module.set_tracer(module.Tracer(enabled=True))
        try:
            run()
            return [(ph, name, track, args) for _, _, _, ph, name, track, _, args
                    in module.tracer().events() if name.startswith("generate.")]
        finally:
            module.set_tracer(prev)

    want = spans(jtrace, lambda: jserve.make_generate(jcfg, japi)(
        jp, {"tokens": jnp.asarray(prompts)}, 4))
    got = spans(ttrace, lambda: make_generate(tcfg, tapi)(
        tp, {"tokens": torch.from_numpy(prompts)}, 4))
    assert got == want
    assert [(ph, name) for ph, name, _, _ in got] == [
        ("B", "generate.prefill"), ("E", "generate.prefill"),
        ("B", "generate.chain"), ("E", "generate.chain")]
    assert got[0][3] == {"batch": 2, "seq": 5} and got[2][3] == {"steps": 3}


# --------------------------------------------------- the server's loops
PLEN = 8


@pytest.fixture(scope="module")
def qwen():
    _, _, _, tcfg, _, tp = _weights("qwen1.5-4b")
    return tcfg, tp


def _serve(cfg, params, prompts, gens, *, replay, draft=None, buckets=(PLEN,), **kw):
    """Serve ``prompts``; the replayed run under the span tracer, so that
    its graph cache logs each replay's copy-ins."""
    api = get_model(cfg)
    kernels = ModelKernels(cfg, api, params, draft=draft, graph=replay)
    group = DeviceGroup("g", device="cpu")
    if replay:
        kernels.graphs = CPUReplay()
        group.graphs = CPUReplay()  # the prefill waves' graphs
    kw.setdefault("max_batch", 2)
    kw.setdefault("seg_len", 2)
    prev = ttrace.set_tracer(ttrace.Tracer(enabled=replay))
    try:
        with InferenceServer(cfg, api, params, groups=[group],
                             buckets=buckets, max_new_cap=16, max_wait_ms=5.0,
                             kernels=kernels, draft=draft, **kw) as srv:
            handles = []
            for p, n in zip(prompts, gens):
                time.sleep(0.002)
                handles.append(srv.submit(p, n))
            results = [h.result(timeout=300) for h in handles]
            stats = srv.stats()
    finally:
        ttrace.set_tracer(prev)
    return results, stats, kernels


SERVED = {
    "contiguous": {},
    "paged": {"paged": PagedSpec(block_len=4)},
    "chunked": {"chunk_len": 3},
    "chunked_paged": {"chunk_len": 3, "paged": PagedSpec(block_len=4)},
    "spec": {"draft": "self"},
    "spec_paged_gated": {"draft": "gated", "paged": PagedSpec(block_len=4)},
    "spec_chunked_paged": {"draft": "self", "chunk_len": 3, "paged": PagedSpec(block_len=4)},
    "spec_chunked_gated": {"draft": "gated", "chunk_len": 3},
}


@pytest.mark.parametrize("layout", list(SERVED))
def test_server_loops_replay_bitwise_eager(qwen, layout):
    """Every server loop through CPUReplay, and every prefill wave through
    the group's compiled kernel, serves the eager server's streams bitwise,
    each equal to one-shot generate of its prompt; no loop is captured
    twice, and none on a live cache; a chunked server replays its loop with
    and without the chunk stage; the group captures the prefill kernels
    only (the segment kernels bind graphs of their own); a paged pool is
    copied in only where a join re-uploads it, never on a segment that only
    decodes."""
    cfg, params = qwen
    kw = dict(SERVED[layout])
    if "paged" in kw:
        # The one-shot reference tiles its cache at the pool's block length.
        cfg = dataclasses.replace(cfg, decode_block=kw["paged"].block_len)
    if "draft" in kw:
        kw["draft"] = DraftSpec(cfg, params, k=2, auto_bypass=kw["draft"] == "gated")
    prompts = [np.random.default_rng(10 + i).integers(0, cfg.vocab, PLEN).astype(np.int32)
               for i in range(3)]
    gens = [7, 4, 9]
    eager, _, _ = _serve(cfg, params, prompts, gens, replay=False, **kw)
    got, stats, _ = _serve(cfg, params, prompts, gens, replay=True, **kw)
    generate = make_generate(cfg, get_model(cfg))
    for p, n, e, r in zip(prompts, gens, eager, got):
        np.testing.assert_array_equal(r, e)
        np.testing.assert_array_equal(
            e, generate(params, {"tokens": torch.from_numpy(p[None])}, n)[0].numpy())
    g = stats["graphs"]
    assert g["replays"] == stats["segments"] > 0
    # One loop a server, times two when gated (the scan and its bypass),
    # times two when chunked (with and without the chunk stage), all
    # captured together before the first segment: no capture warms up on
    # clones of a live cache.
    chunked, gated = "chunk_len" in kw, layout.endswith("gated")
    assert g["captures"] == (1 + gated) * (1 + chunked)
    assert g["warmup_clone_bytes"] == 0
    names = {r[0] for r in g["per_replay"]}
    if chunked:
        assert any(n.endswith("+chunk") for n in names)
        assert any(not n.endswith("+chunk") for n in names)
    w = stats["group_graphs"]["g"]
    assert w["replays"] == (0 if chunked else stats["prefill_waves"])
    assert set(w["loops"]) <= {f"prefill_{PLEN}", f"spec_prefill_{PLEN}"}
    assert w["warmup_clone_bytes"] == 0
    assert w["output_copies"] == w["replays"] * (len(tparams.tree_leaves(
        get_model(cfg).cache_spec(cfg, 1, 8))) * (2 if "draft" in kw else 1) + 1
        + ("draft" in kw))
    moved = [r[2] for r in g["per_replay"]]
    if "paged" in kw:
        # The pool comes back as the loop's own buffers: only a segment
        # after a join copies it in; the others move the control buffers.
        assert min(moved) < max(moved) and sum(m == max(moved) for m in moved) < len(moved)
    else:
        # A contiguous cache is relaid into the loop's buffers each segment.
        assert min(moved) == max(moved)



def test_two_live_buckets_keep_their_pools(qwen):
    """Two buckets' groups live at once over pools of one fixed block count
    (so of one shape): each group's loops take buffers of their own scope,
    and the replayed server serves the eager streams bitwise, each equal to
    one-shot generate of its prompt.  Shared buffers would hand one group's
    pool to the other's next segment."""
    cfg, params = qwen
    cfg = dataclasses.replace(cfg, decode_block=4)
    rng = np.random.default_rng(20)
    prompts = [rng.integers(0, cfg.vocab, n).astype(np.int32) for n in (8, 16, 8, 16, 8, 16)]
    gens = [9, 8, 6, 9, 7, 5]
    kw = dict(paged=PagedSpec(block_len=4, n_blocks=40), buckets=(8, 16))
    eager, _, _ = _serve(cfg, params, prompts, gens, replay=False, **kw)
    got, stats, kernels = _serve(cfg, params, prompts, gens, replay=True, **kw)
    generate = make_generate(cfg, get_model(cfg))
    for p, n, e, r in zip(prompts, gens, eager, got):
        np.testing.assert_array_equal(r, e)
        np.testing.assert_array_equal(
            e, generate(params, {"tokens": torch.from_numpy(p[None])}, n)[0].numpy())
    g = stats["graphs"]
    assert g["replays"] == stats["segments"] and g["captures"] == 2  # one loop a bucket
    assert g["warmup_clone_bytes"] == 0
    # The pool leaves of both buckets have one shape, and a buffer each.
    pools = {}
    for (scope, role, i, shape, _, _), buf in kernels.graphs._buffers.items():
        if role == "cache":
            pools.setdefault(i, {})[scope] = (shape, buf.data_ptr())
    # A scope is the batch's bucket and the group that runs its packages.
    for by_scope in pools.values():
        assert set(by_scope) == {(8, "g"), (16, "g")}
        a, b = by_scope[(8, "g")], by_scope[(16, "g")]
        assert a[0] == b[0] and a[1] != b[1]


# ------------------------------------- DeviceGroup.compile_kernel's graphs
def test_prefill_waves_keep_their_handoff(qwen):
    """Two prefill waves of one shape through the group's compiled kernel,
    the second replayed before anything consumed the first's device-resident
    handoff: a dependent run reading the first wave's leaves through the
    transfer cache gets the first wave's leaves, bitwise the eager wave's.
    A package's results are copied out of the graph's memory, which the
    second replay overwrites."""
    cfg, params = qwen
    kernels = ModelKernels(cfg, get_model(cfg), params)
    group = DeviceGroup("g", device="cpu")
    group.graphs = CPUReplay()
    rt = tcore.Runtime([group])
    rng = np.random.default_rng(30)
    waves = []
    try:
        for _ in range(2):
            tokens = torch.from_numpy(rng.integers(0, cfg.vocab, (2, PLEN)).astype(np.int32))
            prog = tcore.Program().in_(tokens).out(torch.zeros((2, 1), dtype=torch.int32))
            for b in kernels.leaf_mirrors(2, 16):
                prog.out(b)
            prog.kernel(kernels.prefill_kernel(16), f"prefill_{PLEN}").work_items(2, 1)
            rt.submit(prog, tcore.Static()).result()
            waves.append(prog)
        first = waves[0]
        # The consumer reads the first wave's outputs: served from the stash.
        copies = [torch.zeros_like(b) for b in first._outs]
        consumer = tcore.Program()
        for b in first._outs:
            consumer.in_(b)
        for b in copies:
            consumer.out(b)
        consumer.kernel(graphs.passthrough(lambda off, *xs: tuple(x.clone() for x in xs)),
                        "read").work_items(2, 1)
        hits = group.n_cache_hits
        rt.submit(consumer, tcore.Static()).result()
        assert group.n_cache_hits - hits == len(first._outs)  # the device handoff
    finally:
        rt.shutdown()
    want = ModelKernels(cfg, get_model(cfg), params, graph=False).prefill_kernel(16)(
        0, first._ins[0])
    st = group.graphs.stats()
    assert (st["captures"], st["replays"]) == (1, 2)
    for c, h, w in zip(copies, first._outs, want):
        assert torch.equal(h, w)
        assert torch.equal(c, w)


def test_compiled_kernel_offsets_and_passthrough():
    """One graph per package shape serves every offset: the offset reaches
    the kernel as a device scalar.  Dynamic packages of one size over one
    group capture once and replay per package, bitwise the eager kernel's
    result, the pipelined write-back reading results copied out of the
    graph's memory; a kernel marked passthrough is never captured."""
    n = 64
    x = torch.arange(n, dtype=torch.float32)
    results = {}
    for mode in ("eager", "replay", "passthrough"):
        group = DeviceGroup("g", device="cpu")
        if mode != "eager":
            group.graphs = CPUReplay()

        def kern(off, a):
            return a * 2 + off

        if mode == "passthrough":
            graphs.passthrough(kern)
        y = torch.zeros(n)
        prog = tcore.Program().in_(x).out(y).kernel(kern, "k").work_items(n, 8)
        with tcore.EngineCL().use(group).scheduler(tcore.Dynamic(8)).program(prog) as eng:
            eng.run()
            assert not eng.has_errors(), eng.get_errors()
        results[mode] = (y.clone(), group.graphs.stats() if group.graphs else None)
    want = x * 2 + torch.repeat_interleave(torch.arange(0, n, 8), 8)
    for mode, (y, _) in results.items():
        assert torch.equal(y, want), mode
    st = results["replay"][1]
    assert (st["captures"], st["replays"], st["output_copies"]) == (1, 8, 8)
    assert results["passthrough"][1]["captures"] == 0


def test_compiled_kernel_scalar_args():
    """A Program's scalar arguments reach a compiled kernel as device
    scalars, copied in each call, as the reference's jit traces them: a
    float argument that changes between runs replays the one graph of its
    package shape, bitwise the eager kernel's result with the Python
    float; an argument that is neither a Python scalar nor a tensor on the
    group's device is refused with a TypeError."""
    n = 32
    x = torch.from_numpy(np.random.default_rng(50).standard_normal(n).astype(np.float32))

    def kern(off, a, scale, shift):
        return a * scale * a + shift

    replay = DeviceGroup("g", device="cpu")
    replay.graphs = CPUReplay()
    for scale, shift in ((3.0, -1.0), (0.1, 2.5), (-7.25, 1e-3)):
        ys = {}
        for mode, group in (("eager", DeviceGroup("g", device="cpu")), ("replay", replay)):
            y = torch.zeros(n)
            prog = (tcore.Program().in_(x).out(y).kernel(kern, "k").args(scale, shift)
                    .work_items(n, 8))
            with tcore.EngineCL().use(group).scheduler(tcore.Static()).program(prog) as eng:
                eng.run()
                assert not eng.has_errors(), eng.get_errors()
            ys[mode] = y
        assert torch.equal(ys["replay"], ys["eager"]), (scale, shift)
    st = replay.graphs.stats()
    assert (st["captures"], st["replays"]) == (1, 3)
    for bad in (np.float32(1.0), [1.0], np.ones(2, np.float32)):
        fn = replay.compile_kernel(tcore.Program().in_(x).out(torch.zeros(n))
                                   .kernel(kern, "k").args(bad, 0.0))
        with pytest.raises(TypeError, match="compiled kernel takes Program arguments"):
            fn(0, x, bad, 0.0)


def test_capture_wait_is_not_service_time():
    """A package whose capture waits for another thread's capture (one
    runs at a time in the process) reports that wait as its group's
    ``capture_wait_s``, and the scheduler observes the package's service
    time without it."""
    observed = []

    class Recording(tcore.Static):
        def clone(self):  # the runtime runs a clone of the engine's scheduler
            return Recording()

        def observe(self, device, size_wi, seconds):
            observed.append(seconds)
            super().observe(device, size_wi, seconds)

    group = DeviceGroup("g", device="cpu")
    group.graphs = CPUReplay()
    x = torch.arange(8, dtype=torch.float32)
    prog = tcore.Program().in_(x).out(torch.zeros(8)).kernel(lambda off, a: a + 1, "k")
    prog.work_items(8, 8)
    held, release = threading.Event(), threading.Event()

    def hold():
        with graphs._CAPTURE_LOCK:
            held.set()
            release.wait(5)

    holder = threading.Thread(target=hold)
    holder.start()
    held.wait(5)
    threading.Timer(0.3, release.set).start()
    t0 = time.perf_counter()
    with tcore.EngineCL().use(group).scheduler(Recording()).program(prog) as eng:
        eng.run()
        assert not eng.has_errors(), eng.get_errors()
    wall = time.perf_counter() - t0
    holder.join()
    assert group.capture_wait_s >= 0.25
    assert group.graphs.stats()["wait_s"] == group.capture_wait_s
    assert len(observed) == 1 and observed[0] <= wall - group.capture_wait_s


@pytest.mark.parametrize("scheduler", ["static", "hguided"])
def test_coexec_packages_replay_bitwise_oneshot(qwen, scheduler):
    """Co-executed generate over two groups (pod-a and pod-b) whose compiled
    kernels replay graphs of the whole eager generate: every package's
    tokens equal one-shot generate of the batch, as the launcher's
    ``--coexec --verify`` holds; each group replays once per package and
    captures once per package shape it met."""
    from repro_torch.launch import serve as launcher

    cfg, params = qwen
    api = get_model(cfg)
    tokens = torch.from_numpy(np.random.default_rng(40).integers(0, cfg.vocab, (6, PLEN))
                              .astype(np.int32))
    gen = 5
    want = make_generate(cfg, api)(params, {"tokens": tokens}, gen).numpy()
    generate = make_generate(cfg, api, graph=False)
    groups = launcher.coexec_groups("cpu")
    for g in groups:
        g.graphs = CPUReplay()
    out = torch.zeros((6, gen), dtype=torch.int32)
    prog = (tcore.Program().in_(tokens).out(out)
            .kernel(lambda off, t: generate(params, {"tokens": t}, gen), "generate")
            .work_items(6, 1))
    eng = tcore.EngineCL().use(*groups).scheduler(launcher.SCHEDULERS[scheduler]())
    with eng.program(prog):
        eng.run()
        assert not eng.has_errors(), eng.get_errors()
        recs = list(eng.introspector.records)
    np.testing.assert_array_equal(out.numpy(), want)
    for g in groups:
        sizes = [r.size_wi for r in recs if r.device == g.name]
        st = g.graphs.stats()
        assert st["replays"] == len(sizes) > 0
        assert st["captures"] == len({tcore.DeviceGroup._bucket(s, 1) for s in sizes})
        assert st["warmup_clone_bytes"] == 0
