"""Speculative serving in the port vs the JAX package: ports of
tests/test_spec_decode.py on reduced internlm2-20b (GQA n_rep 4, float32,
weights materialized in JAX and loaded with ``load_jax_params``), the spec
cases of tests/test_multigroup.py (single group), tests/test_obs.py's
gate journal and the draft cases of tests/test_chunked_prefill.py.

- ``make_draft_verify_step`` against the JAX step on the same weights: y,
  cnt, tok', ptok' and pos' equal, the verify's logits within 5e-5; driven
  to GEN tokens, bitwise the port's one-shot generate (self draft and a
  disagreeing one), under both ``kernel_impl`` values.
- Served: contiguous and paged, mid-stream joins and exits, prefix hits,
  self-drafting at acceptance 1.0, chunked prefill, the gate: every stream
  bitwise the port's batch-1 one-shot generate, a few also held against
  the JAX package's tokens; transfer counts of the spec layouts equal the
  JAX package's.
- Accounting: ``spec_segments_for``, the acceptance EMA, the
  ``blocks_needed`` spec reserve, every ``validate_draft`` gate (and the
  kernels' row limit), and the exited-slot write clamp of contiguous
  caches."""
import dataclasses
import time

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro import configs as jconfigs
from repro import serve as jserve
from repro.models import get_model as jax_get_model
from repro.models import params as jparams
from repro_torch import configs as tconfigs
from repro_torch.core import DeviceGroup, Static
from repro_torch.core.obs import DecisionJournal
from repro_torch.kernels import _build
from repro_torch.launch import serve as launcher
from repro_torch.models import get_model
from repro_torch.models import params as tparams
from repro_torch.serve import (
    DraftSpec,
    InferenceServer,
    PagedSpec,
    ServiceModel,
    SpecGate,
    blocks_needed,
    make_draft_verify_step,
    make_generate,
    make_prefill_step,
    segments_for,
    spec_segments_for,
    validate_draft,
    zeros_cache,
)

PLEN, GEN = 8, 9
IMPLS = ["reference", "cuda"]
# Whole-model float32 verify logits across the two frameworks: the
# kernels' 2e-5 holds per kernel; through the stack, whose products sum in
# other orders, one verify row reaches 2.8e-5 (on a logit of -0.085), so
# the limit sits just above that.
LOGITS_TOL = 5e-5


def _jax_weights(arch, seed):
    jcfg = jconfigs.reduced(jconfigs.get_config(arch))
    jp = jparams.materialize(jax_get_model(jcfg).param_spec(jcfg, 1),
                             jax.random.PRNGKey(seed), jnp.float32)
    tcfg = tconfigs.reduced(tconfigs.get_config(arch))
    tp = tparams.load_jax_params(jax.tree_util.tree_map(np.asarray, jp), tcfg, "cpu")
    return jcfg, jp, tcfg, tp


@pytest.fixture(scope="module")
def model():
    """Reduced internlm2-20b (GQA target), seed 0: (JAX cfg, JAX params,
    port cfg, port params)."""
    return _jax_weights("internlm2-20b", 0)


@pytest.fixture(scope="module")
def weak(model):
    """Same arch, seed 7: a draft that disagrees with the target (low
    acceptance), exercising the rejection path."""
    return _jax_weights("internlm2-20b", 7)


@pytest.fixture(scope="module")
def qwen():
    return _jax_weights("qwen1.5-4b", 0)


def port(m, impl="reference", block_len=4):
    """(cfg, api, params) of a port model; under "cuda" the one-shot
    reference tiles its cache at the pool's block length."""
    cfg = dataclasses.replace(m[2], kernel_impl=impl,
                              decode_block=block_len if impl == "cuda" else 0)
    return cfg, get_model(cfg), m[3]


def prompts_for(vocab, seed, n, plen=PLEN):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, plen).astype(np.int32) for _ in range(n)]


def oneshot(cfg, api, params, prompt, n):
    return make_generate(cfg, api)(params, {"tokens": torch.from_numpy(prompt[None])},
                                   n)[0].numpy()


def jax_oneshot(m, prompt, n):
    jcfg, jp = m[0], m[1]
    gen = jserve.make_generate(jcfg, jax_get_model(jcfg))
    return np.asarray(gen(jp, {"tokens": jnp.asarray(prompt[None])}, n))[0]


def cpu_group(name="spec"):
    return [DeviceGroup(name, device="cpu")]


def serve(cfg, api, params, prompts, gens, *, stagger=0.0, **kw):
    kw.setdefault("groups", cpu_group())
    kw.setdefault("buckets", (PLEN,))
    kw.setdefault("max_batch", 2)
    kw.setdefault("seg_len", 2)
    kw.setdefault("max_new_cap", 16)
    kw.setdefault("max_wait_ms", 5.0)
    with InferenceServer(cfg, api, params, **kw) as srv:
        handles = []
        for p, n in zip(prompts, gens):
            time.sleep(stagger)
            handles.append(srv.submit(p, n))
        results = [h.result(timeout=300) for h in handles]
        stats = srv.stats()
        metrics = srv.metrics()
    return results, stats, [h.metrics for h in handles], metrics


# ------------------------------------------------------------ unit step
@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("draft,k", [("self", 2), ("weak", 1), ("weak", 3)])
def test_draft_verify_step_emits_one_shot_chain(model, weak, impl, draft, k):
    """Driving make_draft_verify_step, built as the server builds it (the
    bucket as ``prompt_len``), to GEN tokens reproduces the port's one-shot
    generate bitwise, with the target drafting for itself (full acceptance)
    and with a disagreeing draft; its first step equals the JAX package's
    step on the same weights (y, cnt, tok', ptok' and pos' exactly, the
    verify's logits within 5e-5), though the JAX step re-decodes the draft
    cache's last prompt entry where the port's keeps prefill's."""
    cfg, api, params = port(model, impl)
    dparams = params if draft == "self" else weak[3]
    b = 2
    prompts = np.stack(prompts_for(cfg.vocab, 21, b))
    want = np.stack([oneshot(cfg, api, params, p, GEN) for p in prompts])

    step = make_draft_verify_step(cfg, api, cfg, api, k, prompt_len=PLEN)
    prefill = make_prefill_step(cfg, api)
    max_seq = PLEN + GEN + 4 * (k + 1)
    tokens = torch.from_numpy(prompts)
    cache = zeros_cache(cfg, api, b, max_seq, device="cpu")
    dcache = zeros_cache(cfg, api, b, max_seq, device="cpu")
    tok, cache = prefill(params, {"tokens": tokens}, cache)
    _, dcache = prefill(dparams, {"tokens": tokens}, dcache)
    ptok = tokens[:, -1:].to(torch.int32)
    pos = torch.full((b,), PLEN, dtype=torch.int32)

    jout = _jax_first_step(model, weak, draft, k, prompts, tok, cache, pos, ptok) \
        if impl == "reference" else None
    bufs = [[int(tok[i, 0])] for i in range(b)]
    while min(len(x) for x in bufs) < GEN:
        y, cnt, tok, ptok, pos, cache, dcache = step(params, dparams, cache, dcache, tok,
                                                     ptok, pos)
        if jout is not None:
            for got, ref in zip((y, cnt, tok, ptok, pos), jout):
                np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
            jout = None
        assert cnt.dtype == torch.int32 and pos.dtype == torch.int32
        assert all(1 <= c <= k + 1 for c in cnt.tolist()), cnt
        for i in range(b):
            bufs[i].extend(y[i, :int(cnt[i])].tolist())
    got = np.stack([np.asarray(x[:GEN]) for x in bufs])
    np.testing.assert_array_equal(got, want)


def _jax_first_step(model, weak, draft, k, prompts, tok, cache, pos, ptok):
    """The JAX package's first draft/verify step from the same prompts
    (its prefill token held equal to the port's), and the verify decode's
    logits held against the port's from a copy of the port's cache."""
    cfg, api, params = port(model)
    b, max_seq = prompts.shape[0], cache["k"].shape[2]
    jcfg, jp = model[0], model[1]
    jdp = jp if draft == "self" else weak[1]
    japi = jax_get_model(jcfg)
    jstep = jserve.make_draft_verify_step(jcfg, japi, jcfg, japi, k)
    jprefill = jserve.make_prefill_step(jcfg, japi)
    jcache = jserve.zeros_cache(jcfg, japi, b, max_seq)
    jdcache = jserve.zeros_cache(jcfg, japi, b, max_seq)
    jtok, jcache = jprefill(jp, {"tokens": jnp.asarray(prompts)}, jcache)
    _, jdcache = jprefill(jdp, {"tokens": jnp.asarray(prompts)}, jdcache)
    np.testing.assert_array_equal(tok.numpy(), np.asarray(jtok))
    jout = jstep(jp, jdp, jcache, jdcache, jtok, jnp.asarray(ptok.numpy()),
                 jnp.asarray(pos.numpy()))
    xs = torch.cat([tok, torch.zeros((b, k), dtype=torch.int32)], dim=1)
    tlog, _ = api.decode(params, xs, pos, cfg, {n: x.clone() for n, x in cache.items()})
    jlog, _ = japi.decode(jp, jnp.asarray(xs.numpy()), jnp.asarray(pos.numpy()), jcfg,
                          jcache)
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), atol=LOGITS_TOL,
                               rtol=LOGITS_TOL)
    return jout[:5]


# ------------------------------------------------------------- servers
@pytest.mark.parametrize("impl", IMPLS)
def test_server_contiguous_spec_midstream_bit_identity(model, weak, impl):
    """Weak draft, staggered arrivals, mixed lengths (slots join and exit a
    running decode mid-stream): every stream equals one-shot generate, and
    the speculation counters account every drafted token."""
    cfg, api, params = port(model, impl)
    prompts = prompts_for(cfg.vocab, 31, 6)
    gens = [GEN, 4, GEN, 6, GEN, 5]
    results, s, mets, metrics = serve(cfg, api, params, prompts, gens, stagger=2e-3,
                                      draft=DraftSpec(cfg, weak[3], k=2))
    for p, n, got in zip(prompts, gens, results):
        np.testing.assert_array_equal(got, oneshot(cfg, api, params, p, n))
    if impl == "reference":
        np.testing.assert_array_equal(results[0], jax_oneshot(model, prompts[0], GEN))
    assert s["completed"] == 6 and s["failed"] == 0
    assert s["tokens_drafted"] > 0
    assert 0.0 <= s["acceptance"] <= 1.0
    for m in mets:
        assert m["drafted"] == m["accepted"] + m["rejected_drafts"]
        assert 0.0 <= m["acceptance"] <= 1.0
    spec = metrics["speculation"]
    assert spec["k"] == 2
    assert spec["tokens_drafted"] == sum(m["drafted"] for m in mets)
    assert spec["acceptance_ema"] is not None


@pytest.mark.parametrize("impl", IMPLS)
def test_server_self_draft_full_acceptance(model, impl):
    """The target drafting for itself accepts every candidate: acceptance
    == 1 and every step emits k+1 tokens (the upper bound of the
    accounting)."""
    cfg, api, params = port(model, impl)
    prompts = prompts_for(cfg.vocab, 41, 3)
    # The three requests board one wave whatever the host's load: the
    # group forms when the third arrives (max_batch), not when a window
    # of a few ms expires.
    results, s, _, _ = serve(cfg, api, params, prompts, [GEN] * 3, max_batch=3,
                             max_wait_ms=60_000.0, draft=DraftSpec(cfg, params, k=2))
    for p, got in zip(prompts, results):
        np.testing.assert_array_equal(got, oneshot(cfg, api, params, p, GEN))
    assert s["acceptance"] == 1.0
    assert s["tokens_accepted"] == s["tokens_drafted"] > 0
    # GEN - 1 = 8 tokens after the first at 3 a step, 2 steps a segment.
    assert s["segments"] == spec_segments_for(GEN, 2, 3.0) == 2


@pytest.mark.parametrize("impl", IMPLS)
def test_server_paged_spec_bit_identity_with_prefix_hits(model, weak, impl):
    """Paged pool + drafting: staggered joins and exits, duplicate prompts
    (the kept chain-level block sharing registers prefix hits; whole-prompt
    and wave-mate reuse are off), weak draft k=2: streams stay bitwise and
    every pool block returns."""
    cfg, api, params = port(model, impl)
    base = prompts_for(cfg.vocab, 51, 3)
    prompts = [base[0], base[1], base[0], base[2], base[0]]  # repeats: hits
    gens = [GEN, 5, GEN, 6, 4]
    results, s, _, _ = serve(cfg, api, params, prompts, gens, stagger=2e-3,
                             paged=PagedSpec(block_len=4), draft=DraftSpec(cfg, weak[3], k=2))
    for p, n, got in zip(prompts, gens, results):
        np.testing.assert_array_equal(got, oneshot(cfg, api, params, p, n))
    assert s["tokens_drafted"] > 0
    mem = s["memory"]
    assert mem["mode"] == "paged"
    assert mem["prefix_hits"] > 0, mem
    # Whatever is still in use is cache retention: no live request holds a block.
    assert mem["blocks_in_use"] == mem["blocks_cached"], mem


@pytest.mark.parametrize("paged", [None, PagedSpec(block_len=4)], ids=["contiguous", "paged"])
def test_server_spec_kernel_path_bit_identity(model, weak, paged):
    """The multi-row verify through the kernels' path (``kernel_impl="cuda"``,
    their plain versions on CPU tensors): drafted streams match one-shot
    generate on the same kernel config, as the JAX suite's Pallas case."""
    cfg, api, params = port(model, "cuda")
    prompts = prompts_for(cfg.vocab, 61, 2)
    results, _, _, _ = serve(cfg, api, params, prompts, [5, 5], max_new_cap=8, paged=paged,
                             draft=DraftSpec(cfg, weak[3], k=2))
    for p, got in zip(prompts, results):
        np.testing.assert_array_equal(got, oneshot(cfg, api, params, p, 5))


# --------------------------------------------------- chunked prefill drafts
@pytest.mark.parametrize("paged,chunk_len", [(None, 2), (PagedSpec(block_len=4), 3)],
                         ids=["contiguous", "paged"])
def test_draft_chunked_bit_identical(qwen, paged, chunk_len):
    """Speculative decoding on top of chunked prefill: the chunk stage
    advances the draft cache too, and streams stay bitwise (ports of
    test_draft_chunked_bit_identical and test_paged_draft_chunked_bit_identical)."""
    cfg, api, params = port(qwen)
    dparams = _jax_weights("qwen1.5-4b", 9)[3]
    prompts = prompts_for(cfg.vocab, 24, 4)
    results, s, _, _ = serve(cfg, api, params, prompts, [6] * 4, max_batch=4,
                             max_new_cap=10, chunk_len=chunk_len, paged=paged,
                             draft=DraftSpec(cfg, dparams, k=2))
    for p, r in zip(prompts, results):
        np.testing.assert_array_equal(r, oneshot(cfg, api, params, p, 6))
    np.testing.assert_array_equal(results[0], jax_oneshot(qwen, prompts[0], 6))
    assert s["tokens_drafted"] > 0 and s["chunk_len"] == chunk_len


# ------------------------------------------------------------ the gate
def test_spec_gate_probe_and_bypass():
    sm = ServiceModel(alpha=1.0)
    gate = SpecGate(sm, k=2, probe_every=4)
    assert gate.decide(8) is True           # spec cold: measure it first
    sm.observe("seg_spec", 8, 0.30)
    assert gate.decide(8) is False          # plain cold: one plain probe
    sm.observe("seg_plain", 8, 0.05)
    sm.observe_acceptance(2, 0.0)           # tokens_per_step == 1.0
    assert gate.forecast_speedup(8) < 1.0
    assert gate.decide(8) is False and not gate.speculating(8)
    sm.observe("seg_plain", 8, 0.90)        # plain got expensive: flip back
    assert gate.speculating(8)
    assert gate.decide(8) is True
    # Steady state re-probes the losing mode every probe_every segments.
    decisions = [gate.decide(8) for _ in range(4)]
    assert decisions == [True, False, True, True]
    s = gate.stats([8])
    assert s["probes"] == 2 and s["bypassed_segments"] >= 3
    assert s["buckets"][8]["mode"] == "spec"


@pytest.mark.parametrize("paged", [None, PagedSpec(block_len=4)], ids=["contiguous", "paged"])
def test_server_spec_auto_bypass_stays_bit_identical(qwen, paged):
    """Poisoned forecast (spec segments look 10^4x slower than plain): the
    gate runs plain segments, drafting is bypassed, and every stream still
    equals one-shot generate: the mode moves cost, never bits."""
    cfg, api, params = port(qwen)
    prompts = prompts_for(cfg.vocab, 61, 3)
    with InferenceServer(cfg, api, params, groups=cpu_group("gate"), scheduler=Static(),
                         buckets=(PLEN,), max_batch=3, seg_len=2, max_new_cap=12,
                         max_wait_ms=5.0, paged=paged,
                         draft=DraftSpec(cfg, params, k=2, auto_bypass=True)) as srv:
        srv.admission.model.observe("seg_spec", PLEN, 100.0)
        srv.admission.model.observe("seg_plain", PLEN, 1e-4)
        results = [h.result(timeout=300) for h in [srv.submit(p, 6) for p in prompts]]
        s = srv.stats()
    for p, got in zip(prompts, results):
        np.testing.assert_array_equal(got, oneshot(cfg, api, params, p, 6))
    assert s["completed"] == 3
    assert s["speculation"]["k"] == 2
    assert s["speculation"]["bypassed_segments"] >= 1, s["speculation"]


def test_spec_gate_flips_land_in_journal():
    model = ServiceModel()
    gate = SpecGate(model, k=2, probe_every=1000)
    gate.journal = DecisionJournal(cap=16)
    # Warm both modes, spec fast first; then make spec slow: a flip.
    model.observe("seg_spec", 8, 0.01)
    model.observe("seg_plain", 8, 0.1)
    assert gate.decide(8)  # first settled decision: spec (no flip yet)
    for _ in range(40):  # drag the spec EMA above plain
        model.observe("seg_spec", 8, 10.0)
    assert not gate.decide(8)  # flipped to plain
    snap = gate.journal.snapshot()
    assert snap["counts"].get("spec_gate") == 1
    rec = [r for r in snap["recent"] if r["kind"] == "spec_gate"][-1]
    assert rec["mode"] == "plain" and rec["bucket"] == 8
    assert rec["forecast_speedup"] is not None


# --------------------------------------------------- transfers and launcher
@pytest.mark.parametrize("paged,chunk_len", [(False, 0), (True, 0), (True, 3)],
                         ids=["contiguous", "paged", "paged-chunked"])
def test_spec_transfer_counts_match_jax(qwen, paged, chunk_len):
    """The spec layouts keep the JAX package's buffer order and join
    protocol (ptok, the draft mirrors behind the target's, spec_on last),
    so one wave served through both servers makes the same host-to-device
    transfers and transfer-cache hits, and the same tokens."""
    from repro.core import DeviceGroup as JaxDeviceGroup
    from repro.core import Static as JaxStatic

    jcfg, jp = qwen[0], qwen[1]
    cfg, api, params = port(qwen)
    prompts = prompts_for(cfg.vocab, 29, 2)
    kw = dict(buckets=(PLEN,), max_batch=2, seg_len=2, max_new_cap=10, max_wait_ms=50.0,
              chunk_len=chunk_len)
    with jserve.InferenceServer(jcfg, jax_get_model(jcfg), jp, groups=[JaxDeviceGroup("x")],
                                scheduler=JaxStatic(),
                                paged=jserve.PagedSpec(block_len=4) if paged else None,
                                draft=jserve.DraftSpec(jcfg, jp, k=2), **kw) as srv:
        want = [h.result(timeout=300) for h in [srv.submit(p, 6) for p in prompts]]
        jx = srv.stats()["transfers"]["x"]
    with InferenceServer(cfg, api, params, groups=[DeviceGroup("x", device="cpu")],
                         scheduler=Static(), paged=PagedSpec(block_len=4) if paged else None,
                         draft=DraftSpec(cfg, params, k=2), **kw) as srv:
        got = [h.result(timeout=300) for h in [srv.submit(p, 6) for p in prompts]]
        tx = srv.stats()["transfers"]["x"]
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert (tx["transfers"], tx["cache_hits"]) == (jx["transfers"], jx["cache_hits"]), (tx, jx)


@pytest.mark.parametrize("extra", [["--paged"], [], ["--paged", "--spec-gate"]],
                         ids=["paged", "contiguous", "gated"])
def test_launcher_spec_server_verify_on_cpu(extra, capsys):
    res = launcher.main(["--arch", "qwen1.5-4b", "--server", "--draft", "self",
                         "--draft-k", "2", "--device", "cpu", "--verify", "--requests", "6",
                         "--prompt-len", "8", "--gen", "5", *extra])
    out = capsys.readouterr().out
    assert "verify: 6 results bit-identical" in out, out
    s = res["stats"]
    assert s["completed"] == 6 and s["tokens_drafted"] > 0
    if "--spec-gate" in extra:
        assert "spec gate:" in out
    else:
        assert "draft tokens accepted (acceptance=1.00)" in out, out


def test_launcher_full_draft_reduced_rejected():
    """At --full only --draft self passes validate_draft: the reduced
    configs' vocab is 256 (built here without loading the full model)."""
    args = launcher.parse_args(["--arch", "qwen1.5-4b", "--full", "--server", "--draft",
                                "reduced", "--device", "cpu"])
    full = tconfigs.get_config("qwen1.5-4b")
    draft = launcher.make_draft(full, None, args)
    assert draft.cfg.vocab == 256 and draft.k == 2
    with pytest.raises(ValueError, match="vocab"):
        validate_draft(full, draft)
    assert launcher.make_draft(full, None, launcher.parse_args(
        ["--arch", "qwen1.5-4b", "--server", "--device", "cpu"])) is None


# ------------------------------------------------------------ accounting
def test_spec_segments_for_degrades_and_forecasts():
    for gen in (1, 2, 5, 9):
        assert spec_segments_for(gen, 2, 1.0) == segments_for(gen, 2)
        assert spec_segments_for(gen, 2, 2.6) == jserve.spec_segments_for(gen, 2, 2.6)
    # 9 tokens after prefill's first: 8 left; 2 steps/segment * 2.6 tok/step
    assert spec_segments_for(9, 2, 2.6) == 2
    assert spec_segments_for(9, 2, 3.0) == 2
    assert spec_segments_for(1, 2, 3.0) == 0
    # tokens_per_step below 1 is clamped (a step always emits >= 1)
    assert spec_segments_for(9, 2, 0.1) == segments_for(9, 2)


def test_service_model_acceptance_ema():
    sm = ServiceModel(alpha=0.5)
    assert sm.acceptance(2) is None
    assert sm.tokens_per_step(2) == 1.0  # cold: conservative plain rate
    assert sm.tokens_per_step(0) == 1.0
    sm.observe_acceptance(2, 1.0)
    assert sm.tokens_per_step(2) == 3.0
    sm.observe_acceptance(2, 0.0)
    assert sm.acceptance(2) == 0.5
    sm.observe_acceptance(2, 5.0)       # clamped to 1.0
    assert sm.acceptance(2) == 0.75
    sm.observe_acceptance(4, float("nan"))  # ignored
    assert sm.acceptance(4) is None
    assert sm.tokens_per_step(4) == 1.0


def test_blocks_needed_spec_reserve():
    # speculation off (0 or 1) keeps the plain forecast
    assert blocks_needed(8, 6, 2, 4) == blocks_needed(8, 6, 2, 4, spec_step=1)
    # the reserve covers the worst case: the last segment may start at
    # bucket + gen - 2 and write seg_len * (k+1) verify rows past it
    want = -(-(8 + 6 - 2 + 2 * 3) // 4)
    assert blocks_needed(8, 6, 2, 4, spec_step=3) == want
    assert blocks_needed(8, 6, 2, 4, spec_step=3) == jserve.blocks_needed(8, 6, 2, 4,
                                                                          spec_step=3)
    assert blocks_needed(8, 6, 2, 4, spec_step=3) >= blocks_needed(8, 6, 2, 4)
    # gen <= 1 never decodes: no reserve beyond the prompt
    assert blocks_needed(8, 1, 2, 4, spec_step=3) == -(-8 // 4)


def test_validate_draft_gates(model):
    cfg, _, params = port(model)
    ok = DraftSpec(cfg, params, k=2)
    validate_draft(cfg, ok)  # a sane pair passes
    with pytest.raises(ValueError, match="vocab"):
        validate_draft(cfg, DraftSpec(dataclasses.replace(cfg, vocab=cfg.vocab + 1),
                                      params, k=2))
    hybrid = tconfigs.reduced(tconfigs.get_config("recurrentgemma-2b"))
    with pytest.raises(ValueError, match="per-position timeline"):
        validate_draft(hybrid, DraftSpec(hybrid, params, k=2))
    ssm = tconfigs.reduced(tconfigs.get_config("falcon-mamba-7b"))
    with pytest.raises(ValueError, match="per-position timeline"):
        validate_draft(cfg, DraftSpec(dataclasses.replace(ssm, vocab=cfg.vocab), params, k=2))
    with pytest.raises(ValueError, match="rolling window"):
        validate_draft(dataclasses.replace(cfg, window=8), ok)
    with pytest.raises(ValueError, match="seq_shard_cache"):
        validate_draft(dataclasses.replace(cfg, seq_shard_cache=True), ok)
    with pytest.raises(ValueError, match="k must be"):
        DraftSpec(cfg, params, k=0)
    # The kernels' row limit: the verify's (k+1) * n_rep rows (n_rep 4 here).
    kcfg = dataclasses.replace(cfg, kernel_impl="cuda")
    n_rep = cfg.n_heads // cfg.n_kv_heads
    deepest = _build.MAX_ROWS // n_rep - 1
    validate_draft(kcfg, DraftSpec(kcfg, params, k=deepest))
    with pytest.raises(ValueError, match="rows"):
        validate_draft(kcfg, DraftSpec(kcfg, params, k=deepest + 1))
    validate_draft(cfg, DraftSpec(cfg, params, k=deepest + 1))  # no kernel, no limit
    # The server validates at construction.
    with pytest.raises(ValueError, match="rolling window"):
        InferenceServer(dataclasses.replace(cfg, window=8), get_model(cfg), params,
                        groups=cpu_group(), draft=ok)


# ------------------------------------------- exited slots on contiguous caches
def test_exited_slot_writes_stay_in_its_row(model):
    """An exited slot keeps decoding past max_seq on static shapes: its k+1
    verify rows (and its draft rows) are clamped into its own row's last
    entries (``step.write_start``), so a live neighbour's entries are
    untouched and no index is out of range; unclamped, the write fails."""
    cfg, api, params = port(model)
    k, max_seq, b = 2, 20, 2
    step = make_draft_verify_step(cfg, api, cfg, api, k, prompt_len=PLEN, cap=max_seq)
    prefill = make_prefill_step(cfg, api)
    tokens = torch.from_numpy(np.stack(prompts_for(cfg.vocab, 71, b)))
    caches = []
    for _ in range(2):
        c = zeros_cache(cfg, api, b, max_seq, device="cpu")
        tok, c = prefill(params, {"tokens": tokens}, c)
        caches.append(c)
    cache, dcache = caches
    ptok = tokens[:, -1:].to(torch.int32)
    pos = torch.tensor([PLEN, max_seq + 5], dtype=torch.int32)  # slot 1: exited, past the end
    before = [{n: x.clone() for n, x in c.items()} for c in (cache, dcache)]
    step(params, params, cache, dcache, tok, ptok, pos)
    for c, old in zip((cache, dcache), before):
        for name in ("k", "v", "pos"):
            new, was = c[name], old[name]
            # Slot 0 (live): only its own positions PLEN - 1 .. PLEN + k move.
            keep = [i for i in range(max_seq) if not PLEN - 1 <= i <= PLEN + k]
            assert torch.equal(new[:, 0][:, keep], was[:, 0][:, keep]), name
            # Slot 1 (exited): only its last k + 2 entries move.
            assert torch.equal(new[:, 1][:, :max_seq - k - 2], was[:, 1][:, :max_seq - k - 2])
    assert cache["pos"][:, 1, max_seq - k - 1:].tolist() == [
        list(range(max_seq - k - 1, max_seq))] * cfg.n_layers
    unclamped = make_draft_verify_step(cfg, api, cfg, api, k, prompt_len=PLEN)
    with pytest.raises((IndexError, RuntimeError)):
        unclamped(params, params, cache, dcache, tok, ptok, pos)


def test_first_draft_step_keeps_prompt_entries(qwen):
    """The first draft step leaves the draft cache's last prompt entry as
    prefill wrote it, the bits the target's cache holds there (a 2-row
    decode would rewrite it from the decode path, whose deeper layers' keys
    differ from the prefill's: here flash_decode_plain's tiles against
    flash_attention_plain's), and writes the pending token's entry."""
    cfg, api, params = port(qwen, "cuda")
    b, k, max_seq = 2, 2, 24
    tokens = torch.from_numpy(np.stack(prompts_for(cfg.vocab, 81, b)))
    prefill = make_prefill_step(cfg, api)
    caches = []
    for _ in range(2):
        c = zeros_cache(cfg, api, b, max_seq, device="cpu")
        tok, c = prefill(params, {"tokens": tokens}, c)
        caches.append(c)
    cache, dcache = caches
    before = {n: x.clone() for n, x in dcache.items()}
    step = make_draft_verify_step(cfg, api, cfg, api, k, prompt_len=PLEN, cap=max_seq)
    pos = torch.full((b,), PLEN, dtype=torch.int32)
    y, cnt, *_ = step(params, params, cache, dcache, tok, tokens[:, -1:], pos)
    assert cnt.tolist() == [k + 1] * b  # a self-draft accepts everything
    for n in ("k", "v", "pos"):
        assert torch.equal(dcache[n][:, :, :PLEN], before[n][:, :, :PLEN]), n
    assert not torch.equal(dcache["k"][:, :, PLEN], before["k"][:, :, PLEN])
    assert dcache["pos"][:, :, PLEN].tolist() == [[PLEN] * b] * cfg.n_layers
