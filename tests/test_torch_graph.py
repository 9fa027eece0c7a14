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
  graph does: through it the chain and the server's loops (plain,
  contiguous and paged, the mixed kernels' decode part, the speculative
  scan and its bypass) use the static buffers, copy-ins and write-backs
  exactly as on the card, and must give the eager streams bitwise.
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

        return Replay(), outputs


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
    a second call of the same shape captures nothing and copies no cache
    (prefill wrote the graph's static cache in place)."""
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
    assert (st["captures"], st["replays"]) == (1, 2)
    # Each call copies in the prefill's token and the start position only.
    assert copies == [2, 2]
    # Another batch is another shape; the first shape's graph stays.
    np.testing.assert_array_equal(replayed(tp, {"tokens": batch["tokens"][:1]}, gen).numpy(),
                                  eager[:1])
    assert replayed.graphs.stats()["captures"] == 2


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
    if replay:
        kernels.graphs = CPUReplay()
    kw.setdefault("max_batch", 2)
    kw.setdefault("seg_len", 2)
    prev = ttrace.set_tracer(ttrace.Tracer(enabled=replay))
    try:
        with InferenceServer(cfg, api, params, groups=[DeviceGroup("g", device="cpu")],
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
}


@pytest.mark.parametrize("layout", list(SERVED))
def test_server_loops_replay_bitwise_eager(qwen, layout):
    """Every server loop through CPUReplay serves the eager server's
    streams bitwise, each equal to one-shot generate of its prompt; no loop
    is captured twice, and none on a live cache; a paged pool is copied in
    only where a join re-uploads it, never on a segment that only
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
    # One loop a server, two when gated (the scan and its bypass, captured
    # together before the first segment): no capture warms up on clones of
    # a live cache.
    assert g["captures"] == (2 if layout.endswith("gated") else 1)
    assert g["warmup_clone_bytes"] == 0
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
    for by_scope in pools.values():
        assert set(by_scope) == {8, 16}
        assert by_scope[8][0] == by_scope[16][0] and by_scope[8][1] != by_scope[16][1]
